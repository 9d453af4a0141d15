"""A fixture reader: the steps of the traced window."""


def read(record):
    return record["counters"].get("steps")
