"""The device's idle share of the traced window of a train cell (rank 0): 1 - the
union of its operations' intervals over the window's wall, in %."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
