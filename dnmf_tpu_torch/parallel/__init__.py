"""Partitioning layer over ``torch.distributed``: meshes of ranks,
frame- and voxel-sharded training steps with the +-1-frame trace halo,
sharded streaming, registration and refinement, and batched recordings.

Counterpart of ``dnmf_tpu/parallel``; every rank runs the same call on
its own shard.  :func:`~dnmf_tpu_torch.parallel.sharded.gather_state`
(the whole state on every rank) and
:func:`~dnmf_tpu_torch.parallel.mesh.gather_time` are the counterparts of
reading back a sharded array."""

from dnmf_tpu_torch.parallel.batched import (
    batched_round,
    stack_states,
    unstack_states,
)
from dnmf_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_distributed,
    process_summary,
)
from dnmf_tpu_torch.parallel.mesh import gather_time, make_mesh, video_sharding
from dnmf_tpu_torch.parallel.registration import (
    sharded_register_pwrigid,
    sharded_register_rigid,
)
from dnmf_tpu_torch.parallel.sharded import (
    gather_state,
    shard_state,
    shard_video,
    sharded_compute_grams,
    sharded_footprint_update,
    sharded_motion_epoch,
    sharded_refined_rounds,
)
from dnmf_tpu_torch.parallel.streaming import (
    sharded_compute_grams_streaming,
    sharded_motion_epoch_streaming,
)

__all__ = [
    "batched_round",
    "stack_states",
    "unstack_states",
    "make_mesh",
    "initialize_distributed",
    "is_distributed",
    "process_summary",
    "video_sharding",
    "sharded_compute_grams",
    "sharded_footprint_update",
    "sharded_motion_epoch",
    "sharded_motion_epoch_streaming",
    "sharded_compute_grams_streaming",
    "sharded_register_rigid",
    "sharded_register_pwrigid",
    "shard_state",
    "shard_video",
]
