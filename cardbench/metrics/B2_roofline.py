"""B2, the masked log-domain Sinkhorn of inference (`log_optimal_transport_masked`): the least time its operations need over the traced window
(`harness/roofline.py`, from each call's shapes and inputs) over the
device time of the operations launched inside the `cardbench:sinkhorn`
ranges, in %."""


def read(record):
    dev = record.get("trace", {}).get("range_device", {}).get("sinkhorn")
    bound = record.get("bounds", {}).get("sinkhorn")
    if not dev or not dev["ops"] or not bound or dev["seconds"] <= 0:
        return None
    return 100.0 * bound / dev["seconds"]
