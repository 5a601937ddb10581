"""Median, over the traced prefills, of the bytes that the MoE FFNs' gathers,
casts and scatters write outside the expert products: the ``copy_bytes``
of the program's ``moe`` spans within each ``prefill`` span
(``repro_torch.core.scope``), in GiB.  None where the program records no
``copy_bytes`` on a ``moe`` span in a prefill."""
import statistics


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    by_id = {s.id: s for s in spans}
    prefills = {s.id: 0 for s in spans if s.tag == "prefill"}
    found = False
    for s in spans:
        if s.tag != "moe" or "copy_bytes" not in s.attrs:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.id not in prefills:
            p = by_id.get(p.parent)
        if p is not None:
            prefills[p.id] += s.attrs["copy_bytes"]
            found = True
    return statistics.median(prefills.values()) / 2**30 if found else None
