"""clause_roofline.online: the training-mode clause counts' (K3) share of
the HBM roofline in the traced ticks."""
import readers


def read(run):
    return readers.clause_roofline(run) if run.spans.get("tick") else None
