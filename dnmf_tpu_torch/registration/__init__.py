"""Registration stack of the port: FFT rigid / piecewise-rigid motion
correction and shift propagation onto tracked neuron positions."""

from dnmf_tpu_torch.registration.motion_correct import (
    MotionCorrect,
    high_pass_filter_space,
    patch_grid,
    rigid_correct_frames,
    tile_and_correct,
    tile_and_correct_block,
)

__all__ = [
    "MotionCorrect",
    "high_pass_filter_space",
    "patch_grid",
    "rigid_correct_frames",
    "tile_and_correct",
    "tile_and_correct_block",
]
