"""Rank 0's device time per traced step in NCCL's kernels (the gradient,
loss, normaliser and synced-BN all-reduces; by kernel name), ms. An NCCL
kernel runs from its launch until every rank has joined, so a rank that
arrives late lengthens it."""


def read(record):
    tr = record.get("trace") or {}
    coll = tr.get("collectives")
    if not coll or not coll["kernels"] or not tr.get("steps"):
        return None
    return 1e3 * coll["nccl_s"] / tr["steps"]
