"""Median seconds a request spends in the vision tower (ViT in 128-frame
chunks, K3), from the engine's stage timer."""

from portbench.readers import stage_median


def read(run):
    return stage_median(run, "vision_tower")
