"""Share (%) of rank 0's device time in NCCL kernels (the data-parallel
step's collectives)."""

import re

from h100_bench import trace

NCCL = re.compile("nccl", re.IGNORECASE)


def read(record):
    total = trace.device_us(record)
    nccl = trace.device_us(record, NCCL)
    if total <= 0 or nccl <= 0:
        return None
    return 100.0 * nccl / total
