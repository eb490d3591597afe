"""Model layer: the deformable-NMF state and its update steps (gradient
deformation fits and multiplicative trace updates)."""

from dnmf_tpu_torch.models.dnmf import (
    DNMFState,
    batch_loss,
    compute_grams,
    footprint_update,
    init_state,
    make_motion_optimizer,
    motion_epoch_parallel,
    motion_epoch_parity,
    reconstruct,
    spatial_pushforward,
)

__all__ = [
    "DNMFState",
    "batch_loss",
    "compute_grams",
    "footprint_update",
    "init_state",
    "make_motion_optimizer",
    "motion_epoch_parallel",
    "motion_epoch_parity",
    "reconstruct",
    "spatial_pushforward",
]
