"""The train forward's span per step in the window, ms: CUDA events around
`train_forward` (detection, matcher, criterion, matching and camera losses)."""


def read(record):
    span = record.get("spans", {}).get("forward")
    if not span or not span["calls"]:
        return None
    return span["device_ms"] / span["calls"]
