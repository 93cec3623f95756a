"""setup_s: process start to the window's start on the host's clock:
imports, the weights, the port's build (and, in a fresh checkout, nvcc),
the traffic, and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
