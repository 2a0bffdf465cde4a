"""The backbone's span per batch in the window, ms: CUDA events on the stream
around `backbone.forward` (one call per batch, both views), which include
the gaps while the host still launches its kernels."""


def read(record):
    span = record.get("spans", {}).get("backbone")
    if not span or not span["calls"]:
        return None
    return span["device_ms"] / span["calls"]
