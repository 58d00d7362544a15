"""Set-up: from the process's start to the window's (imports, building
the model and its weights, the kernels' first build, warming every shape
of the cell's traffic)."""


def read(run):
    return run.setup_s
