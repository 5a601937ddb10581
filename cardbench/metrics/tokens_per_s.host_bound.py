"""Prompt tokens prefilled plus tokens generated, over the window's length,
in the cells whose decode steps the host bounds (the card idles through
most of a step), where the host's speed spreads it between processes by
3-7%: a name of its own, so that its wider bound will not hide a loss in a
cell that the card bounds.  A cell where it spreads more reports it per
layer, as ``tokens_per_s.unbounded``."""


def read(run):
    tokens = sum(r.batch.size * (r.batch.prompt + r.batch.output) for r in run.records)
    return tokens / run.window_s if run.window_s > 0 else None
