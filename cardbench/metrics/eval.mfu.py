"""The eval step's share of the card's peak over the window: the pairs'
FLOPs (the configuration's count per pair) over the window's wall and the
configuration's peak rate, in %."""


def read(record):
    if not record.get("pairs") or not record.get("window_s"):
        return None
    rate = record["pairs"] * record["pair_flops"] / record["window_s"]
    return 100.0 * rate / record["peak_flop_per_s"]
