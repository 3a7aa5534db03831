"""K3's share of its roofline over a traced 1-token request: the summed
least time of its calls (portbench/counts.py) over their device time."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "k3", "prefill")
