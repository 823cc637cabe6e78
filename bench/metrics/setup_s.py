"""setup_s: seconds from the process's start (the first statement of
bench/run.py) to the window's open: imports, the kernel library, the
weights, the engine and its pool, the warm-up steps."""


def read(run):
    return run.t_open - run.t_start
