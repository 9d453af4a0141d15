"""Host milliseconds a training step waits for its batch: ``next(loader)``
+ ``loop.to_device_batch``, by the host clock, summed over a whole cycle
run untraced just before the traced one, per step."""


def read(record):
    loader_s = record["counters"].get("loader_s")
    steps = record["counters"].get("steps")
    if not loader_s or not steps:
        return None
    return loader_s * 1e3 / steps
