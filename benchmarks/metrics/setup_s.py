"""setup_s: seconds from process start to the first timed request (the
torch import, the CUDA context, the kernel libraries' load or build,
the cell's data made on the card and its shapes warmed)."""


def read(run):
    return run.setup_s
