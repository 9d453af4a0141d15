"""Device milliseconds of the generator (G_ema) per generated image:
the device time of the kernels launched in the benchmark's
``generator`` span around the callable it hands to ``MetricOptions``."""


def read(record):
    images = record["counters"].get("images")
    spans = [dev for name, _, _, dev in record["spans"] if name == "generator"]
    if not images or not spans:
        return None
    return sum(spans) / 1e3 / images
