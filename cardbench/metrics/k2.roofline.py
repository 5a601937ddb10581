"""K2's bound over the device time of the ranges around its call site
(``models.ssm.ssd_chunked``, its layout copies included), summed over the
traced calls (%).  The bound is the yardstick's, at each call's shapes."""
from cardbench.yardstick import bound_s, k2_work


def read(run):
    rs = run.trace.of("ssd") if run.trace else []
    device = sum(r.device_s for r in rs)
    if not rs or device <= 0:
        return None
    bound = 0.0
    for r in rs:
        (b, S, H, P), (_, _, G, N) = r.meta["x"], r.meta["B"]
        bound += bound_s(*k2_work(b, H, S, P, G, N, x_itemsize=r.meta["x_itemsize"],
                                  dt_itemsize=r.meta["dt_itemsize"]), run.card)
    return 100.0 * bound / device
