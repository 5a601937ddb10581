"""95th percentile, over every request of the window, of the host-clock
time from its batch's start to its first token on the host (ms)."""
from cardbench.yardstick import percentile


def read(run):
    values = [(r.stamps[0] - r.t0) * 1e3 for r in run.records for _ in range(r.batch.size)]
    return percentile(values, 95) if values else None
