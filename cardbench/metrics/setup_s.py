"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the weights drawn, the program built and every shape warmed."""


def read(run):
    return run.setup_s
