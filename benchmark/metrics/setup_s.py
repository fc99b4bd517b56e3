"""Seconds from the process's start to the window's first request: weights
and data made, the system built, kernels built or loaded, and every shape
of the window warmed up."""


def read(run):
    return run.setup_s
