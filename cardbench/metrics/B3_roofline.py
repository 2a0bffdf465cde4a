"""B3, the fused focal and dice sums of the mask loss (`fused_focal_dice`), forward
and backward (the backward's range from the gradient reaching its outputs
to its leaving the logits): the least time its operations need over the traced window
(`harness/roofline.py`, from each call's shapes and inputs) over the
device time of the operations launched inside the `cardbench:mask_loss`
ranges, in %."""


def read(record):
    dev = record.get("trace", {}).get("range_device", {}).get("mask_loss")
    bound = record.get("bounds", {}).get("mask_loss")
    if not dev or not dev["ops"] or not bound or dev["seconds"] <= 0:
        return None
    return 100.0 * bound / dev["seconds"]
