"""The matching head's span per batch in the window, ms: CUDA events around
`matching_head.forward` (the GNN and Sinkhorn, launch-bound)."""


def read(record):
    span = record.get("spans", {}).get("matching_head")
    if not span or not span["calls"]:
        return None
    return span["device_ms"] / span["calls"]
