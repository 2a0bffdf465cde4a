"""The host's time per step of the traced window in the CUDA runtime calls
that wait for the device (stream, event and device synchronisations,
copies to or from pageable memory), ms."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps") or not tr["waits_s"]:
        return None
    return 1e3 * sum(tr["waits_s"].values()) / tr["steps"]
