"""Device time inside ``models.attention.attention`` called with
impl="flash", as a share of the traced prefills' device time (%)."""


def read(run):
    if not run.trace:
        return None
    part = sum(r.device_s for r in run.trace.of("attention"))
    whole = sum(r.device_s for r in run.trace.of("prefill"))
    return 100.0 * part / whole if part > 0 and whole > 0 else None
