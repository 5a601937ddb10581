"""Median host ms of a traced decode step: the length of the program's
``decode`` span (``repro_torch.core.scope``), the host's time to enqueue one
step.  The harness synchronises the card before the step, so nothing
enqueued earlier is charged to it.  None where the program records no spans."""
import statistics


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    steps = [s.end_ns - s.start_ns for s in spans if s.tag == "decode"]
    return statistics.median(steps) / 1e6 if steps else None
