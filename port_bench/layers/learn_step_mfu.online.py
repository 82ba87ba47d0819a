"""learn_step_mfu.online: the learning steps' int8-sized operations (two an
automaton) over the untraced ticks' seconds x 1,979 TOP/s."""
import readers


def read(run):
    return readers.mfu_pct(run, "tick")
