"""Host seconds inside the traced decode-step ranges in which no device
operation ran, as a share of their length (%), in the cells whose decode
steps the host bounds, under the name of the end-to-end metric it moves
there (``tokens_per_s.host_bound``)."""


def read(run):
    rs = run.trace.of("decode") if run.trace else []
    host = sum(r.host_s for r in rs)
    if host <= 0 or not any(r.device_s > 0 for r in rs):
        return None
    return 100.0 * sum(r.idle_s for r in rs) / host
