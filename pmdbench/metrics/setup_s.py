"""Seconds from the process's start to the measured window: interpreter,
torch and the port's import, the kernel build on a checkout's first run,
the movie, and the warm-up on the cell's own shapes."""


def read(run):
    return run.get("setup_s")
