"""Share (%) of the device time spent in depthwise-convolution kernels:
the plain route of ``upfirdn2d``, for FIR calls outside the hand
kernels' contract (StyleGAN3's x4 up-filters)."""

import re

from h100_bench import trace

DEPTHWISE = re.compile("depthwise", re.IGNORECASE)


def read(record):
    total = trace.device_us(record)
    if total <= 0:
        return None
    return 100.0 * trace.device_us(record, DEPTHWISE) / total
