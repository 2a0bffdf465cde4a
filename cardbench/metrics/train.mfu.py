"""The train step's share of the card's peak over the window: the steps'
FLOPs (the configuration's count per step, 3x the forward) over the
window's wall and the configuration's peak rate, in %."""


def read(record):
    if not record.get("steps") or not record.get("window_s"):
        return None
    rate = record["steps"] * record["step_flops"] / record["window_s"]
    return 100.0 * rate / record["peak_flop_per_s"]
