"""Median device ms of a traced decode step (``LM.decode``), in the cells
whose decode steps the host bounds, under the name of the end-to-end metric
it moves there (``tokens_per_s.host_bound``)."""
import statistics


def read(run):
    rs = run.trace.of("decode") if run.trace else []
    if not rs or not any(r.device_s > 0 for r in rs):
        return None
    return statistics.median(r.device_s * 1e3 for r in rs)
