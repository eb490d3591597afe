"""Device meshes over a process group, and how a video splits over them.

Counterpart of ``dnmf_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh`` of devices; here every rank is
one process that drives one device and runs the same engine call on its
own shard (SPMD over processes).  :func:`make_mesh` arranges the ranks of
the process group as a ``(batch, time, pixel)``
:class:`~torch.distributed.device_mesh.DeviceMesh`: ``batch`` partitions
recordings, ``time`` frames, and ``pixel`` the voxels of a frame (tensor
parallelism of the ``[K, K]`` Grams at large K).  Collectives run over
the mesh's per-axis groups, ``mesh.get_group("time")`` and
``mesh.get_group("pixel")``.

The process group must exist first (:func:`~dnmf_tpu_torch.parallel.
distributed.initialize_distributed`, or ``torchrun``).  A ``gloo`` group
takes CPU and CUDA tensors (its collectives stage CUDA tensors through
the host), ``nccl`` CUDA tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

TIME_AXIS = "time"
BATCH_AXIS = "batch"
PIXEL_AXIS = "pixel"
AXES = (BATCH_AXIS, TIME_AXIS, PIXEL_AXIS)


def make_mesh(num_time: Optional[int] = None, num_batch: int = 1,
              num_pixel: int = 1):
    """The ranks of the process group as a ``(batch, time, pixel)``
    ``DeviceMesh``; ``num_time`` defaults to what the other two leave of
    the world size, and the three must multiply to it.  Its device type
    is ``"cuda"`` for an ``nccl`` group, else ``"cpu"`` (a ``gloo`` group,
    whose ranks may still hold CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: call "
            "dnmf_tpu_torch.parallel.initialize_distributed(...) in every "
            "rank first (or start the ranks with torchrun)")
    world = dist.get_world_size()
    if num_time is None:
        num_time = world // max(num_batch * num_pixel, 1)
    shape = (int(num_batch), int(num_time), int(num_pixel))
    if min(shape) < 1 or shape[0] * shape[1] * shape[2] != world:
        raise ValueError(f"mesh (batch, time, pixel) = {shape} does not "
                         f"cover the {world} ranks of the process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if mesh is None:
        return 0
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def _comm_tensor(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend takes it: an ``nccl`` group takes
    CUDA tensors only."""
    if dist.get_backend() == "nccl" and x.device.type != "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x.contiguous()


def all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM):
    """``x`` reduced over the mesh's ``axis`` (``x`` itself where the axis
    has one rank), on ``x``'s device."""
    if axis_size(mesh, axis) == 1:
        return x
    buf = _comm_tensor(x).clone()
    dist.all_reduce(buf, op=op, group=mesh.get_group(axis))
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh, axis: str):
    """The list of every rank's ``x`` along the mesh's ``axis``, in axis
    order (``[x]`` where the axis has one rank), on ``x``'s device."""
    n = axis_size(mesh, axis)
    if n == 1:
        return [x]
    buf = _comm_tensor(x)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.get_group(axis))
    return [p.to(x.device) for p in parts]


def gather_time(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """A time-sharded tensor whole on every rank: the ranks' shards
    along the ``time`` axis, concatenated on ``dim`` (the counterpart of
    reading back a time-sharded ``jax.Array``)."""
    return torch.cat(all_gather(x, mesh, TIME_AXIS), dim=dim)


@dataclasses.dataclass(frozen=True)
class VideoSharding:
    """This rank's block of a ``[T, P]`` video: frames split over the
    ``time`` axis, voxels over ``pixel`` (contiguous equal runs)."""

    num_time: int
    time_index: int
    num_pixel: int
    pixel_index: int

    def frames(self, t: int) -> slice:
        n = t // self.num_time
        return slice(self.time_index * n, (self.time_index + 1) * n)

    def voxels(self, p: int) -> slice:
        n = p // self.num_pixel
        return slice(self.pixel_index * n, (self.pixel_index + 1) * n)

    def p_offset(self, p: int) -> Optional[int]:
        """The first of this rank's voxels of a ``P``-voxel volume, the
        kernels' ``p_offset`` (None without a pixel axis: the whole
        volume)."""
        return self.voxels(p).start if self.num_pixel > 1 else None


def video_sharding(mesh) -> VideoSharding:
    """Video ``[T, P]``: frames over the time axis, voxels over the pixel
    axis (whole frames where it has one rank)."""
    return VideoSharding(axis_size(mesh, TIME_AXIS),
                         axis_index(mesh, TIME_AXIS),
                         axis_size(mesh, PIXEL_AXIS),
                         axis_index(mesh, PIXEL_AXIS))
