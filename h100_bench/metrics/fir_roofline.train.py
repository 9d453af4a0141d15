"""Share (%) of their roofline that the hand FIR kernels (K5–K7) reach:
the least time of the recorded ``fir_planes`` calls
(``h100_bench/counts/fir.py``) over the device time of the FIR kernels.
Nothing to read where no FIR kernel ran."""

from h100_bench import trace


def read(record):
    kernel_us = trace.device_us(record, trace.FIR_KERNEL)
    least_s = record["counters"].get("fir_least_s", 0.0)
    if kernel_us <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s * 1e6 / kernel_us
