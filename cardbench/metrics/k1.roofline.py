"""K1's bound over the device time of the ranges around its call site
(``kernels.ops.flash_attention``, its layout copies included), summed over
the traced calls (%).  The bound is the yardstick's, at each call's shapes."""
from cardbench.yardstick import bound_s, k1_work


def read(run):
    rs = run.trace.of("k1") if run.trace else []
    device = sum(r.device_s for r in rs)
    if not rs or device <= 0:
        return None
    bound = 0.0
    for r in rs:
        (B, Sq, H, hd), (_, Skv, K, _) = r.meta["q"], r.meta["k"]
        bound += bound_s(*k1_work(B, H, K, Sq, Skv, hd, causal=r.meta["causal"],
                                  itemsize=r.meta["itemsize"]), run.card)
    return 100.0 * bound / device
