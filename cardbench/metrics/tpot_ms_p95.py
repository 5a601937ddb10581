"""95th percentile, over every gap between two consecutive output tokens of
every request of the window, of the gap on the host clock (ms)."""
from cardbench.yardstick import percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.records for a, b in zip(r.stamps, r.stamps[1:])
            for _ in range(r.batch.size)]
    return percentile(gaps, 95) if gaps else None
