"""Model FLOPs of the traced prefills over the device time inside them
(every kernel whose midpoint lies in a prefill range) times the card's bf16
peak (%).  The FLOPs are the yardstick's count from the configuration and
the prompt lengths.  Device time leaves out the gaps that the tracer's own
synchronisation at each inner range opens; the idle share of a prefill is
``device.idle_pct.prefill``."""
from cardbench.yardstick import prefill_flops


def read(run):
    rs = run.trace.of("prefill") if run.trace else []
    device = sum(r.device_s for r in rs)
    if not rs or device <= 0:
        return None
    flops = sum(prefill_flops(run.cfg, r.meta["batch"], r.meta["prompt"]) for r in rs)
    return 100.0 * flops / (device * run.card["bf16_flops"])
