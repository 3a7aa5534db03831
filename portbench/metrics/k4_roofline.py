"""K4's share of its roofline over the traced stretch of serving: the
summed least time of its calls (portbench/counts.py) over their device
time."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "k4", "serve")
