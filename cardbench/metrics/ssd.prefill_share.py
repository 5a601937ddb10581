"""Device time inside ``models.ssm.ssd_chunked`` (K2 and its layout copies),
as a share of the traced prefills' device time (%)."""


def read(run):
    if not run.trace:
        return None
    part = sum(r.device_s for r in run.trace.of("ssd"))
    whole = sum(r.device_s for r in run.trace.of("prefill"))
    return 100.0 * part / whole if part > 0 and whole > 0 else None
