"""Kernel launches on the device per real image in the traced cycle."""


def read(record):
    images = record["counters"].get("images")
    kernels = sum(1 for op in record["ops"] if op[3])
    if not images or not kernels:
        return None
    return kernels / images
