"""Median device ms of a traced decode step (``LM.decode``)."""
import statistics


def read(run):
    rs = run.trace.of("decode") if run.trace else []
    if not rs or not any(r.device_s > 0 for r in rs):
        return None
    return statistics.median(r.device_s * 1e3 for r in rs)
