"""launches_per_step.online: device kernels launched inside the traced
ticks, over their learning steps."""
import readers


def read(run):
    return readers.launches_per_step(run, "tick")
