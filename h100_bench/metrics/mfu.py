"""The whole step's or pass's share (%) of the card's peak: the least time
of the convolutions and dense layers the traced work requires
(``h100_bench/counts``: bf16 layers at 989 TFLOP/s, float32 layers at
67) over the host-clock seconds of the same work run untraced just
before the traced window (``mfu.train``, ``mfu.eval``)."""


def read(record):
    least_s = record["counters"].get("least_s")
    untraced_s = record["counters"].get("untraced_s")
    if not least_s or not untraced_s:
        return None
    return 100.0 * least_s / untraced_s
