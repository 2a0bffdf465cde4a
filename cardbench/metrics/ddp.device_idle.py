"""Rank 0's card's idle share of its traced steps: 1 - the union of its
operations' intervals over the traced window's wall, in %."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
