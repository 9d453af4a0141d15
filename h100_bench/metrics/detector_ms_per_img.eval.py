"""Device milliseconds of the detector (InceptionV3 with its resize) per generated image:
the device time of the kernels launched in the benchmark's
``detector`` span around the callable it hands to ``MetricOptions``."""


def read(record):
    images = record["counters"].get("images")
    spans = [dev for name, _, _, dev in record["spans"] if name == "detector"]
    if not images or not spans:
        return None
    return sum(spans) / 1e3 / images
