"""Registration over the time axis of a mesh: each rank one chunk.

Counterpart of ``dnmf_tpu/parallel/registration.py``.  The reference
registers a recording in chunks of frames mapped over worker processes
and takes the NaN-aware median of the chunk templates as the next
template.  Here each rank of the ``time`` axis is one chunk: it corrects
its own contiguous frames in blocks of ``cfg.frame_block`` (rigid:
:func:`~dnmf_tpu_torch.registration.motion_correct.rigid_correct_frames`;
piecewise rigid: :func:`~dnmf_tpu_torch.registration.motion_correct.
pwrigid_block`, kernels F and G on the card), forms its chunk template
(the mean over finite values, NaN where none, then NaN to the minimum),
and one ``all_gather`` hands every rank all the chunk templates, whose
median (:func:`dnmf_tpu_torch.ops.fft_reg.nanmedian`, NumPy's rule for an
even count; not ``torch.nanmedian``, which takes the lower middle value)
is the next template.  A rank's frame blocks replay the captured block
steps of a single-process pass (:func:`~dnmf_tpu_torch.models.graphs.
rigid_block`, :func:`~dnmf_tpu_torch.models.graphs.pwrigid_block`;
eagerly inside ``models.graphs.disabled()``); the ``all_gather`` and the
median run eagerly, once per iteration.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dnmf_tpu_torch.config import RegistrationConfig
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import fft_reg
from dnmf_tpu_torch.parallel.mesh import (TIME_AXIS, all_gather, axis_size,
                                          video_sharding)
from dnmf_tpu_torch.registration import motion_correct as mc_lib


def _check(video, cfg: RegistrationConfig, mesh) -> None:
    if cfg.gSig_filt is not None:
        raise ValueError("gSig_filt is not supported on the mesh path")
    if video.shape[0] % axis_size(mesh, TIME_AXIS):
        raise ValueError("T must divide evenly over the time mesh axis")


def _iterate(video, cfg: RegistrationConfig, mesh, template, iters: int,
             correct_block, device):
    """``iters`` template iterations on this rank's frames; returns
    ``(template, corrected [T_loc, ...] host, shifts [T_loc, ...])``."""
    video = mc_lib._host_video(video)
    local = video[video_sharding(mesh).frames(video.shape[0])]
    idx = np.arange(local.shape[0])
    template = torch.as_tensor(template, dtype=torch.float32).to(device)
    corrected = shifts = None
    for _ in range(max(iters, 1)):
        chunk_t, shifts, corrected = mc_lib._stream_chunk(
            local, idx, cfg, correct_block(template), collect=True)
        template = fft_reg.nanmedian(
            torch.stack(all_gather(chunk_t, mesh, TIME_AXIS)), dim=0)
    return template, corrected, shifts


def sharded_register_rigid(video, cfg: RegistrationConfig, mesh,
                           template=None, add_to_movie: float = 0.0,
                           device="cuda"
                           ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Template-iterated rigid registration across the time axis
    (``max(cfg.niter_rig, 1)`` iterations).

    Args:
      video: the whole ``[T, ...spatial]`` recording (NumPy-like or a
        tensor) on every rank; each rank reads its own frames.
      template: initial template; default the bin-median of the video.

    Returns:
      ``(template, corrected [T_loc, ...], shifts [T_loc, nd])``: the
      template on ``device`` (the same on every rank), this rank's frames
      corrected and their shifts, on the host
      (:func:`~dnmf_tpu_torch.parallel.mesh.gather_time` of tensors of
      them gives the whole recording's).
    """
    _check(video, cfg, mesh)
    device = torch.device(device)
    if template is None:
        template = mc_lib._streamed_bin_median(mc_lib._host_video(video),
                                               device)

    add = mc_lib._offset(add_to_movie, device)

    def correct_block(templ):
        return lambda frames, collect: graphs.rigid_block(
            frames, templ, add, cfg, collect)

    return _iterate(video, cfg, mesh, template, cfg.niter_rig, correct_block,
                    device)


def sharded_register_pwrigid(video, cfg: RegistrationConfig, mesh,
                             template=None, add_to_movie: float = 0.0,
                             device="cuda"
                             ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Template-iterated piecewise-rigid registration across the time
    axis, ``max(cfg.niter_rig, 1)`` iterations as the JAX package's (the
    initial template from :func:`sharded_register_rigid` when none is
    given).  Returns ``(template, corrected [T_loc, ...], patch_shifts
    [T_loc, n_patches, nd])``; the shifts are the applied corrections."""
    _check(video, cfg, mesh)
    device = torch.device(device)
    if template is None:
        template, _, _ = sharded_register_rigid(
            video, cfg, mesh, add_to_movie=add_to_movie, device=device)

    add = mc_lib._offset(add_to_movie, device)

    def correct_block(templ):
        return lambda frames, collect: graphs.pwrigid_block(
            frames, templ, add, cfg, collect)

    return _iterate(video, cfg, mesh, template, cfg.niter_rig, correct_block,
                    device)
