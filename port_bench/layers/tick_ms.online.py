"""tick_ms.online: mean milliseconds of a TMService.tick (flush, drain,
analysis and policy), over the window's untraced ticks."""
import readers


def read(run):
    return readers.span_ms(run, "tick")
