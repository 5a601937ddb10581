"""Median, over the traced decode steps, of the bytes that a step's float32
casts of the KV cache read and write: the ``cast_bytes`` of the program's
spans inside each ``decode`` span (``repro_torch.core.scope``), in GiB.
None where the program records no spans."""
import statistics


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    by_id = {s.id: s for s in spans}
    steps = {s.id: 0 for s in spans if s.tag == "decode"}
    for s in spans:
        n = s.attrs.get("cast_bytes", 0)
        p = by_id.get(s.parent)
        while n and p is not None and p.id not in steps:
            p = by_id.get(p.parent)
        if n and p is not None:
            steps[p.id] += n
    return statistics.median(steps.values()) / 2**30 if steps else None
