"""Median, over the traced decode steps, of the host ms inside the
program's ``moe`` spans within each ``decode`` span
(``repro_torch.core.scope``): the host's time to route, dispatch, launch
and combine a step's MoE FFNs.  None where the program records no ``moe``
span in a decode step."""
import statistics


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    by_id = {s.id: s for s in spans}
    steps = {s.id: 0 for s in spans if s.tag == "decode"}
    found = False
    for s in spans:
        if s.tag != "moe":
            continue
        p = by_id.get(s.parent)
        while p is not None and p.id not in steps:
            p = by_id.get(p.parent)
        if p is not None:
            steps[p.id] += s.end_ns - s.start_ns
            found = True
    return statistics.median(steps.values()) / 1e6 if found else None
