"""setup_s: seconds from the process's start to the first timed request
(imports, CUDA start, kernel build or load, inputs, state, warm-up)."""


def read(run):
    return run.setup_s
