"""K4's bound over its device time, summed over the traced calls (%).  The
bound is the yardstick's: the bytes of each ``k4`` span of the program
(``repro_torch.core.scope``; its ``rows``, ``channels``, ``width`` and
``itemsize``), each input and output value once and the weights and bias
once a channel, over the card's memory rate.  The device time is that of
the traced kernels whose name holds ``causal_conv_silu``.  None where the
program records no ``k4`` span or the trace holds no such kernel."""
from cardbench.yardstick import bound_s

KERNEL = "causal_conv_silu"


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    nbytes = sum((2 * s.attrs["rows"] + s.attrs["width"] + 1) * s.attrs["channels"]
                 * s.attrs["itemsize"] for s in spans if s.tag == "k4" and "rows" in s.attrs)
    device = sum(t for name, t in run.trace.ops.items() if KERNEL in name) if run.trace else 0.0
    if nbytes <= 0 or device <= 0:
        return None
    return 100.0 * bound_s(0, nbytes, run.card) / device
