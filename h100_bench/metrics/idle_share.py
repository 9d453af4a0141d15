"""Share (%) of the work's time in which no operation runs on the device,
for ``idle_share.train`` and ``idle_share.eval``: the device's busy
time in the traced window (the union of its operations' intervals) over
the host-clock seconds of the same work run untraced just before.  The
tracer slows a launch-bound host, not the device's operations, so the
traced window's own length would read the tracer's cost.  Nothing to
read where the device's busy time exceeds the untraced time: the trace
would then not be of the same work."""

from h100_bench import trace


def read(record):
    untraced_s = record["counters"].get("untraced_s")
    busy_us = record.get("busy_us", trace.busy_us(record))
    if not untraced_s or not record["ops"] or busy_us > untraced_s * 1e6:
        return None
    return 100.0 * (1.0 - busy_us / (untraced_s * 1e6))
