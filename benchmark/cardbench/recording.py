"""The benchmark's recordings, made on the device from ``--seed``.

The simulator's recipe (anchors uniform inside a margin, exponential
calcium traces of sparse unit spikes, Gaussian cells of squared width
``2 shape_std`` and peak 1, background noise, scaled to a peak of 1),
with the motion written in the model's own terms: frame ``t`` shows the
template through a smooth quadratic warp ``beta_t``, so a voxel ``x`` holds
``sum_k c_kt g(psi_t(x) - p_k)``.  Each cell is drawn only on its box of
voxels (:mod:`references.deformable_nmf`), so a whole-brain recording takes
seconds.  ``beta0`` is the fit's starting warps: ``beta_t`` plus a
seeded error, as registration would seed them.

Where the configuration's ``assumed`` has ``neuron_motion`` (``model``
``"gp"``), the neurons also move on their own, as in a freely moving
worm: frame ``t`` draws cell ``k`` at ``p_k + o_tk``, the offsets ``o_t
[K, 3]`` a draw per frame and axis from ``N(0, a_d RBF(ls))`` over the
anchors' coordinates along that axis (smooth across neurons, white in
time: the reference demo's ``generate_gp_motion``), from a generator of
their own, so every other draw is the one a configuration without it
makes.

Every size and draw is fixed by the configuration's ``size``,
``num_neurons``, ``num_frames``, ``shape_std`` and ``assumed`` and by the
seed; the seed changes values only, never the amount of work.

A configuration with ``storage`` (``{"kind": "raw_float32", "block",
"reader_threads"}``) is drawn the same way, then written block by block
to a raw float32 ``[T, M, N, Z]`` file (:func:`store`): the fit streams
that file through the program's reader, and the check reads it back here
with a NumPy memmap, so the reference judges the bytes the fit streamed.
The file is an anonymous one in memory (``memfd_create``), opened by its
``/proc/self/fd`` path: a page-cached file wherever the run is, whose
reads never leave the host's memory and which writes nothing to disk.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

import numpy as np
import torch

from references import deformable_nmf as ref


@dataclasses.dataclass
class Recording:
    video: torch.Tensor  # [T, M, N, Z] float32, non-negative
    pos: torch.Tensor  # [K, 3] anchors
    beta0: torch.Tensor  # [T, 10, 3] the fit's starting warps

    def frames_flat(self) -> torch.Tensor:
        """``[T, P]``: how the datasets hand a recording to ``fit``."""
        return self.video.reshape(self.video.shape[0], -1)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Frames ``idx`` as ``[len(idx), P]``: what the check reads."""
        return self.frames_flat()[idx]

    def frames(self, start: int, stop: int) -> torch.Tensor:
        """Frames ``[start, stop)`` as ``[stop - start, P]``."""
        return self.frames_flat()[start:stop]


STORED_NAME = "cardbench_recording"  # the in-memory file's name


@dataclasses.dataclass
class StoredRecording:
    """A recording in a raw float32 ``[T, M, N, Z]`` file; no copy stays
    on the card.  The check's reads come from the file, moved to the
    anchors' device.  :meth:`close` frees the file once nothing else
    holds it open."""

    path: str
    shape: Tuple[int, ...]  # (T, M, N, Z)
    pos: torch.Tensor
    beta0: torch.Tensor
    fd: int = -1

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def _flat(self) -> np.memmap:
        return np.memmap(self.path, dtype=np.float32, mode="r",
                         shape=(self.shape[0], math.prod(self.shape[1:])))

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        host = np.ascontiguousarray(self._flat()[idx.cpu().numpy()])
        return torch.from_numpy(host).to(self.pos.device)

    def frames(self, start: int, stop: int) -> torch.Tensor:
        host = np.array(self._flat()[start:stop])
        return torch.from_numpy(host).to(self.pos.device)


def store(rec: Recording, storage: dict) -> StoredRecording:
    """Write ``rec``'s video to a new in-memory file as the
    configuration's ``storage`` says, ``storage["block"]`` frames at a time
    through the host; the caller drops ``rec``, which frees the card's
    copy, and closes the result."""
    if storage["kind"] != "raw_float32":
        raise ValueError(f"unknown storage kind {storage['kind']!r}")
    fd = os.memfd_create(STORED_NAME)
    try:
        t, block = rec.video.shape[0], int(storage["block"])
        with open(fd, "wb", closefd=False) as f:
            for s in range(0, t, block):
                rec.video[s:s + block].cpu().numpy().tofile(f)
    except BaseException:
        os.close(fd)
        raise
    return StoredRecording(f"/proc/self/fd/{fd}", tuple(rec.video.shape),
                           rec.pos, rec.beta0, fd)


# Basis rows by the order of their terms: translation, linear, quadratic.
_GROUPS = ((0,), (1, 2, 3), (4, 5, 6, 7, 8, 9))
# The neuron offsets' generator's seed: the run's seed shifted past 32 bits.
MOTION_SEED_SHIFT = 1 << 32


def _warps(gen, t: int, size, amp_px, harmonics: int, device):
    """``I + delta_t`` ``[T, 10, 3]``: each coefficient a mean of
    ``harmonics`` sines of random frequency (0.5 to 6 cycles per
    recording) and phase, scaled so that its term moves a voxel by at most
    ``amp_px[group][axis]`` pixels."""
    half = torch.tensor([max(float(s) - 1.0, 1.0) / 2.0 for s in size],
                        device=device)
    scale = torch.zeros((10, 3), device=device)
    for group, rows in enumerate(_GROUPS):
        for j in rows:
            scale[j] = torch.tensor(amp_px[group], device=device) / half
    freq = 0.5 + 5.5 * torch.rand((harmonics, 10, 3), generator=gen,
                                  device=device)
    phase = 2 * math.pi * torch.rand((harmonics, 10, 3), generator=gen,
                                     device=device)
    time = torch.arange(t, dtype=torch.float32, device=device) / t
    wave = torch.sin(2 * math.pi * freq[None] * time[:, None, None, None]
                     + phase[None]).mean(dim=1)
    return ref.identity(t, device) + wave * scale


def _traces(gen, k: int, t: int, density: float, device):
    """Unit spikes at ``round(density (T + 9))`` distinct times per neuron,
    convolved with 10 taps ``exp(-0.3 j)``, plus a baseline of 1."""
    n = t + 9
    nnz = int(round(density * n))
    keys = torch.rand((k, n), generator=gen, device=device)
    idx = torch.argsort(keys, dim=1)[:, :nnz]
    spikes = torch.zeros((k, n), device=device).scatter_(1, idx, 1.0)
    taps = torch.exp(-0.3 * torch.arange(10, dtype=torch.float32,
                                         device=device))
    out = torch.zeros((k, t), device=device)
    for j in range(10):
        out += spikes[:, j:j + t] * taps[9 - j]
    return 1.0 + out


def _gp_offsets(gen, pos: torch.Tensor, t: int, motion: dict):
    """``[T, K, 3]`` neuron offsets: per axis ``d`` the root of the RBF
    covariance ``a_d exp(-(x_i - x_j)^2 / (2 ls^2))`` over the anchors'
    ``d`` coordinates (float64 ``eigh``, negative eigenvalues clipped)
    times a standard normal ``[K, T]``."""
    if motion["model"] != "gp":
        raise ValueError(f"unknown neuron motion {motion['model']!r}")
    k, dev = pos.shape[0], pos.device
    eps = torch.randn((3, k, t), generator=gen, device=dev)
    ls = float(motion["length_scale_px"])
    out = []
    for d, amp in enumerate(motion["amplitude_px2"]):
        x = pos[:, d].double()
        cov = float(amp) * torch.exp(-0.5 * ((x[:, None] - x[None, :]) / ls)
                                     ** 2)
        evals, evecs = torch.linalg.eigh(cov)
        root = (evecs * evals.clamp_min(0.0).sqrt()).float()
        out.append(root @ eps[d])  # [K, T]
    return torch.stack(out, dim=-1).permute(1, 0, 2).contiguous()


def make(config: dict, seed: int, device) -> Recording:
    size = tuple(int(s) for s in config["size"])
    k, t = int(config["num_neurons"]), int(config["num_frames"])
    a = config["assumed"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    extent = torch.tensor(size, dtype=torch.float32, device=device)
    margin = torch.minimum(
        torch.tensor(a["anchor_margin_px"], dtype=torch.float32,
                     device=device), (extent - 1.0) / 2.0)
    pos = margin + torch.rand((k, 3), generator=gen, device=device) * (
        extent - 1.0 - 2.0 * margin)
    beta = _warps(gen, t, size, a["warp_px"], a["warp_harmonics"], device)
    traces = _traces(gen, k, t, a["spike_density"], device)
    err = (torch.randn((t, 10, 3), generator=gen, device=device)
           * (beta - ref.identity(1, device)).abs().amax(dim=0)
           * a["start_error"])
    beta0 = beta + err
    pos_t, excursion = None, None
    if "neuron_motion" in a:
        motion_gen = torch.Generator(device=device).manual_seed(
            int(seed) + MOTION_SEED_SHIFT)
        offsets = _gp_offsets(motion_gen, pos, t, a["neuron_motion"])
        pos_t = pos + offsets
        excursion = offsets.abs().amax(dim=(0, 1))
    render = ref.Model(size, pos, math.sqrt(2.0 * float(config["shape_std"])))
    video = torch.empty((t,) + size, dtype=torch.float32, device=device)
    flat = video.view(t, -1)
    box, batches = ref.passes(render, beta, excursion)
    with torch.no_grad():
        for s, e in batches:
            frames = render.recon(render.footprints(
                beta[s:e], box, None if pos_t is None else pos_t[s:e]),
                traces[:, s:e], box)
            flat[s:e] = frames
        peak = float(flat.max())
        noise = float(a["noise_of_peak"]) * peak
        for s, e in batches:
            flat[s:e] += noise * torch.randn(flat[s:e].shape, generator=gen,
                                             device=device)
        flat.clamp_(min=0.0)
        flat.mul_(1.0 / float(flat.max()))
    return Recording(video=video, pos=pos, beta0=beta0)
