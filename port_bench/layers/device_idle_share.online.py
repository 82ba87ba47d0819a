"""device_idle_share.online: the share of the traced sub-window of ticks
with no operation on the card."""
import readers


def read(run):
    return readers.idle_pct(run) if run.spans.get("tick") else None
