"""Median seconds a request spends in SigLIP and in the projector and
pooling, from the engine's stage timer."""

from portbench.readers import stage_median


def read(run):
    return stage_median(run, "vision_tower", "projector_pool")
