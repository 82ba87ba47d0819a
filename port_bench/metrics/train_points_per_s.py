"""train_points_per_s: labelled rows consumed into TA-bank updates,
summed over every replica, over the whole window (its last tick ends
it, after a device sync)."""


def read(run):
    ticks = run.spans.get("tick")
    if not ticks or run.window is None:
        return None
    t0, t1 = run.window
    return sum(sp.work for sp in ticks) / (t1 - t0)
