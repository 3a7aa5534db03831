"""Set-up seconds: from the process start (imports, the kernel build on a
first run, weights drawn on the device, the warm-up of the cell's shapes) to
the start of the measured window."""


def read(run):
    return run.setup_s
