"""B4, the fused 1x1 conv + FrozenBN (+ residual) + ReLU of the backbone's
identity blocks (`conv1x1_bn_act`), replayed inside the backbone's CUDA
graph: the least time of the calls replayed in the traced window
(`harness/fused_tail.py:tail_bound_s`, from each call's shapes) over the
device time of the operations between each call's two markers in the graph
launches, in %. Where a launch lost a marker's record, its calls are left
out and the bound is taken for the share of calls found."""


def read(record):
    tail = record.get("trace", {}).get("tail")
    b4 = record.get("b4")
    if not tail or not b4 or not b4["calls"] or not tail["calls"] or tail["seconds"] <= 0:
        return None
    if tail["calls"] > b4["calls"]:
        return None
    return 100.0 * b4["bound_s"] * tail["calls"] / b4["calls"] / tail["seconds"]
