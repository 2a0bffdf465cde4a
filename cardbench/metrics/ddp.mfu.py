"""The global train step's share of the peak of every card it runs on over
the window: the steps' FLOPs (the configuration's count per global step, 3x
the forward) over the window's wall (rank 0's, after every rank synchronised)
and the ranks' count times the configuration's peak rate, in %."""


def read(record):
    if not record.get("steps") or not record.get("window_s") or not record.get("ranks"):
        return None
    rate = record["steps"] * record["step_flops"] / record["window_s"]
    return 100.0 * rate / (record["ranks"] * record["peak_flop_per_s"])
