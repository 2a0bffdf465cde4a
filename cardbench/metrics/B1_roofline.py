"""B1, the fused mask upsample, argmax and plane stats (`fused_select_maps`): the least time its operations need over the traced window
(`harness/roofline.py`, from each call's shapes and inputs) over the
device time of the operations launched inside the `cardbench:select`
ranges, in %."""


def read(record):
    dev = record.get("trace", {}).get("range_device", {}).get("select")
    bound = record.get("bounds", {}).get("select")
    if not dev or not dev["ops"] or not bound or dev["seconds"] <= 0:
        return None
    return 100.0 * bound / dev["seconds"]
