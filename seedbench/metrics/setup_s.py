"""Set-up seconds: imports, CUDA init, builds, inputs, the index and
the warm chunks, up to the window's start."""


def read(run):
    return run.setup_s
