"""Prompt tokens prefilled plus tokens generated, over the window's length."""


def read(run):
    tokens = sum(r.batch.size * (r.batch.prompt + r.batch.output) for r in run.records)
    return tokens / run.window_s if run.window_s > 0 else None
