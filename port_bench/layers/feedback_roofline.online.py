"""feedback_roofline.online: the fused update's (K9) share of the HBM
roofline in the traced ticks."""
import readers


def read(run):
    return readers.feedback_roofline(run) if run.spans.get("tick") else None
