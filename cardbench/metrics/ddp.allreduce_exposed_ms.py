"""The time per traced step in which an NCCL kernel runs on rank 0's card
and no other kernel does, ms: what overlapping the exchange with the
backward would hide."""


def read(record):
    tr = record.get("trace") or {}
    coll = tr.get("collectives")
    if not coll or not coll["kernels"] or not tr.get("steps"):
        return None
    return 1e3 * coll["exposed_s"] / tr["steps"]
