"""Ground-truthed synthetic video simulator (seeded ``torch.Generator``).

Counterpart of ``dnmf_tpu/data/simulator.py``: videos of moving Gaussian
neurons with known positions ``[K, 3, T]`` and activity traces
``[K, T]``, the fixtures of the end-to-end recovery checks.  The motion
models, trace model, renderer, normalization and cube-mean extractor
are the JAX package's, formula for formula; the random draws come from
an explicit ``torch.Generator`` in place of a JAX key, so a fixture
matches the JAX package's in its statistics, not in its bits.

Every random draw is a private helper (``_uniform``, ``_normal``,
``_spike_indices``), kept apart from the deterministic transform it
feeds (``_anchors_from_uniform``, ``_gp_positions``,
``_gp_time_positions``, ``_quadratic_sequential``, ``_quadratic``,
``_traces_from_spikes``, ``_finish_video``): the same draws give the
JAX package's outputs.  Draws are made on the generator's own device
and then moved to ``device`` (the card unless the caller says
otherwise), so a CPU generator gives the same fixture on the card as on
the CPU, up to the float32 rounding of the transforms.

The GP factors are computed on the host (the kernel matrix in float32,
then a float64 symmetric eigendecomposition with clamped eigenvalues:
these RBF matrices are numerically rank-deficient, and a float32
Cholesky NaNs on them), as in the JAX package.  The near-null
eigenvalues turn a one-ulp change of the matrix into ~1e-4 of the
offsets, so the matrix is made on the host whatever the device.

The host-side NumPy fixtures (``simulate_cell``, ``generate_random_video``,
``simulate_trajectory``) keep ``np.random.default_rng(seed)`` and give the
JAX package's arrays bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from dnmf_tpu_torch.config import SimulatorConfig
from dnmf_tpu_torch.ops.basis import quadratic_basis_points, voxel_grid
from dnmf_tpu_torch.ops.footprints import gaussian_footprints
from dnmf_tpu_torch.utils.volume import as_numpy, placement

# Elements of one [voxels, K] footprint slab while rendering.
RENDER_CHUNK = 1 << 24


# ----------------------------------------------------------------------
# Random draws
# ----------------------------------------------------------------------
def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def _spike_indices(gen: torch.Generator, num_neurons: int, n: int, nnz: int,
                   device) -> torch.Tensor:
    """``[K, nnz]`` distinct times in ``[0, n)`` per neuron."""
    keys = torch.rand((num_neurons, n), generator=gen, device=gen.device)
    return torch.argsort(keys, dim=1)[:, :nnz].to(device)


# ----------------------------------------------------------------------
# Motion models
# ----------------------------------------------------------------------
def _rbf_kernel(x: torch.Tensor, amplitude: float,
                length_scale: float) -> torch.Tensor:
    """``amplitude * exp(-(x_i - x_j)^2 / (2 ls^2))`` over scalar inputs."""
    d = x[:, None] - x[None, :]
    return amplitude * torch.exp(-0.5 * (d / length_scale) ** 2)


def _eigh_host(x: torch.Tensor, amplitude: float, length_scale: float):
    """Float64 ``eigh`` of the float32 RBF matrix over ``x``, on the
    host."""
    cov = _rbf_kernel(x.detach().cpu(), amplitude, length_scale)
    return np.linalg.eigh(cov.numpy().astype(np.float64))


def _anchors_from_uniform(u: torch.Tensor, num_neurons: int, size,
                          min_separation: float = 0.0,
                          margin: float = 0.0) -> torch.Tensor:
    """Anchors from uniform draws ``u``: ``[K, 3]`` without a separation
    constraint, else a pool ``[50 K, 3]`` thinned greedily on the host so
    that no two anchors are closer than ``min_separation``.  The margin is
    clamped per axis to ``(size - 1) / 2``."""
    sz = torch.tensor(size, dtype=torch.float32, device=u.device)
    lo = torch.minimum(torch.full((3,), float(margin), device=u.device),
                       (sz - 1.0) / 2.0)
    hi = sz - lo
    pts = lo + u * (hi - lo)
    if min_separation <= 0.0:
        return pts
    pool = pts.cpu().numpy()
    chosen = [pool[0]]
    for cand in pool[1:]:
        if len(chosen) == num_neurons:
            break
        if np.linalg.norm(np.stack(chosen) - cand, axis=1).min() >= \
                min_separation:
            chosen.append(cand)
    if len(chosen) < num_neurons:
        raise ValueError(
            f"could not place {num_neurons} anchors with separation "
            f"{min_separation} in volume {size} (margin {margin})")
    return torch.as_tensor(np.stack(chosen), device=u.device)


def _sample_anchors(gen, num_neurons, size, min_separation, margin, device):
    n = num_neurons if min_separation <= 0.0 else num_neurons * 50
    return _anchors_from_uniform(_uniform(gen, (n, 3), device), num_neurons,
                                 size, min_separation, margin)


def _gp_positions(anchors: torch.Tensor, eps: torch.Tensor, sigma,
                  length_scale) -> torch.Tensor:
    """Anchors ``[K, 3]`` plus GP offsets over the anchors, per axis
    ``factor_d @ eps[d]`` with ``eps [3, K, T]``: ``[K, 3, T]``."""
    out = []
    for d in range(3):
        evals, evecs = _eigh_host(anchors[:, d], sigma[d], length_scale[d])
        factor = torch.as_tensor(
            (evecs * np.sqrt(np.maximum(evals, 0.0))[None, :]).astype(
                np.float32), device=anchors.device)
        out.append(anchors[:, d][:, None] + factor @ eps[d])
    return torch.stack(out, dim=1)


def gp_motion(generator: torch.Generator, num_neurons: int, num_frames: int,
              sigma=(10.0, 10.0, 10.0), length_scale=(10.0, 10.0, 10.0),
              size=(10, 10, 1), min_separation: float = 0.0,
              margin: float = 0.0, device="cuda") -> torch.Tensor:
    """Gaussian-process motion: anchors uniform in the volume plus, per
    frame and axis, i.i.d. draws from ``N(0, sigma_d RBF(ls_d))`` over the
    anchor coordinates (smooth across neurons, white in time).  Returns
    positions ``[K, 3, T]``."""
    anchors = _sample_anchors(generator, num_neurons, size, min_separation,
                              margin, device)
    eps = _normal(generator, (3, num_neurons, num_frames), device)
    return _gp_positions(anchors, eps, sigma, length_scale)


def _gp_time_positions(anchors: torch.Tensor, eps: torch.Tensor, sigma,
                       length_scale: float) -> torch.Tensor:
    """Anchors ``[K, 3]`` plus temporally smooth GP offsets: per axis
    ``(evecs * sqrt(evals)) @ eps[d].T`` over the frame times, ``eps [3,
    K, T]``.  Returns ``[K, 3, T]``."""
    num_frames = eps.shape[2]
    t = torch.arange(num_frames, dtype=torch.float32)
    offsets = []
    for d in range(3):
        evals, evecs = _eigh_host(t, sigma[d], length_scale)
        root = torch.as_tensor(np.sqrt(np.maximum(evals, 0.0)).astype(
            np.float32), device=anchors.device)
        vecs = torch.as_tensor(evecs.astype(np.float32),
                               device=anchors.device)
        offsets.append((vecs * root[None, :]) @ eps[d].T)
    offsets = torch.stack(offsets, dim=0)  # [3, T, K]
    return anchors[:, :, None] + offsets.permute(2, 0, 1)


def gp_time_motion(generator: torch.Generator, num_neurons: int,
                   num_frames: int, sigma=(2.0, 2.0, 0.1),
                   length_scale: float = 10.0, size=(10, 10, 1),
                   min_separation: float = 0.0, margin: float = 0.0,
                   device="cuda") -> torch.Tensor:
    """Temporally smooth GP motion: each neuron's trajectory along axis
    ``d`` is a draw from ``N(0, sigma_d RBF(length_scale))`` over time.
    Returns positions ``[K, 3, T]``."""
    anchors = _sample_anchors(generator, num_neurons, size, min_separation,
                              margin, device)
    eps = _normal(generator, (3, num_neurons, num_frames), device)
    return _gp_time_positions(anchors, eps, sigma, length_scale)


def _identity_affine_beta(means, device) -> torch.Tensor:
    """``[10, 3]`` identity affine with constant offsets ``means``."""
    b = torch.zeros((10, 3), dtype=torch.float32, device=device)
    b[0, :] = torch.tensor(means, dtype=torch.float32, device=device)
    b[1, 0] = b[2, 1] = b[3, 2] = 1.0
    return b


def _motion_noise_std(snr_db, size, device) -> torch.Tensor:
    """Per-axis noise std ``sqrt(10^(snr/10)) * size``."""
    snr = torch.tensor(snr_db, dtype=torch.float32, device=device)
    sz = torch.tensor(size, dtype=torch.float32, device=device)
    return torch.sqrt(10.0 ** (snr / 10.0)) * sz


def _quadratic_sequential(noise: torch.Tensor, u: torch.Tensor, means,
                          snr_db, size) -> torch.Tensor:
    """Frame-to-frame quadratic motion from unit normals ``noise [T, 10,
    3]`` and uniform ``u [K, 3]``: frame 0 is ``(size - 1) (u / 2 + 1 /
    4)``, frame t the quadratic map ``beta_t`` of frame t - 1.  Returns
    ``[K, 3, T]``."""
    dev = u.device
    std = _motion_noise_std(snr_db, size, dev)
    betas = _identity_affine_beta(means, dev)[None] + noise * std[None, None]
    sz = torch.tensor(size, dtype=torch.float32, device=dev)
    prev = ((sz - 1.0) / 2.0) * u + (sz - 1.0) / 4.0
    pos = [prev]
    for beta_t in betas[1:]:
        prev = quadratic_basis_points(prev) @ beta_t
        pos.append(prev)
    return torch.stack(pos, dim=0).permute(1, 2, 0)


def quadratic_sequential_trajectory(
        generator: torch.Generator, num_neurons: int, num_frames: int,
        means=(0.0, 0.0, 0.0), snr_db=(-2.0, -2.0, -2.0), size=(20, 20, 1),
        device="cuda") -> torch.Tensor:
    """Frame-to-frame quadratic motion (``"sq"``/``"qs"``): each frame's
    positions are a noisy quadratic transform of the previous frame's.
    The noise enters the x^2 terms too, so in the pixel basis it grows
    with the volume.  Returns ``[K, 3, T]``."""
    noise = _normal(generator, (num_frames, 10, 3), device)
    u = _uniform(generator, (num_neurons, 3), device)
    return _quadratic_sequential(noise, u, means, snr_db, size)


def _quadratic(noise: torch.Tensor, u: torch.Tensor, snr_db,
               size) -> torch.Tensor:
    """Cumulative-noise quadratic motion from unit normals ``noise [T, 10,
    3]`` and uniform ``u [K, 3]``.  Returns ``[K, 3, T]``."""
    dev = u.device
    std = _motion_noise_std(snr_db, size, dev)
    betas = (_identity_affine_beta((0.0, 0.0, 0.0), dev)[None]
             + torch.cumsum(noise, dim=0) * std[None, None])
    sz = torch.tensor(size, dtype=torch.float32, device=dev)
    init = (sz - 1.0) * u
    init[:, :2] += 4.0
    phi = quadratic_basis_points(init)  # [K, 10]
    pos = torch.einsum("kb,tbd->tkd", phi, betas)  # [T, K, 3]
    return pos.permute(1, 2, 0)


def quadratic_trajectory(generator: torch.Generator, num_neurons: int,
                         num_frames: int, snr_db=(-2.0, -2.0, -2.0),
                         size=(20, 20, 1), device="cuda") -> torch.Tensor:
    """Cumulative-noise quadratic motion from frame 0 (``"q"``).  Returns
    ``[K, 3, T]``."""
    noise = _normal(generator, (num_frames, 10, 3), device)
    u = _uniform(generator, (num_neurons, 3), device)
    return _quadratic(noise, u, snr_db, size)


# ----------------------------------------------------------------------
# Traces and rendering
# ----------------------------------------------------------------------
def _exp_kernel(device) -> torch.Tensor:
    """The 10 taps ``exp(0, -0.3, ..., -2.7)``."""
    return torch.exp(torch.arange(10, dtype=torch.float32, device=device)
                     * -0.3)


def _traces_from_spikes(idx: torch.Tensor, num_frames: int,
                        baseline: float = 1.0) -> torch.Tensor:
    """Unit spikes at ``idx [K, nnz]`` (times in ``[0, T + 9)``) convolved
    with the exponential kernel, ``"valid"`` part, plus baseline:
    ``[K, T]``.  A convolution flips its kernel: output ``i`` sums
    ``spikes[i + j] * kernel[9 - j]``."""
    kernel = _exp_kernel(idx.device)
    taps = kernel.shape[0]
    n = num_frames + taps - 1
    spikes = torch.zeros((idx.shape[0], n), dtype=torch.float32,
                         device=idx.device)
    spikes.scatter_(1, idx, 1.0)
    out = torch.zeros((idx.shape[0], num_frames), dtype=torch.float32,
                      device=idx.device)
    for j in range(taps):
        out = out + spikes[:, j:j + num_frames] * kernel[taps - 1 - j]
    return baseline + out


def exponential_traces(generator: torch.Generator, num_neurons: int,
                       num_frames: int, density: float = 0.1,
                       baseline: float = 1.0, device="cuda") -> torch.Tensor:
    """Sparse spikes convolved with an exponential kernel: 10 taps
    ``exp(0:-0.3:-3)``, exactly ``round(density * (T + 9))`` unit spikes
    per neuron at distinct times, plus baseline.  Returns ``[K, T]``."""
    n = num_frames + 9
    nnz = int(round(density * n))  # scipy.sparse.rand's nnz rule
    idx = _spike_indices(generator, num_neurons, n, nnz, device)
    return _traces_from_spikes(idx, num_frames, baseline)


def render_video(positions: torch.Tensor, traces: torch.Tensor, size,
                 shape_std: float = 3.0) -> torch.Tensor:
    """Render moving Gaussian cells: ``video[t] = sum_k c[k, t] g_k,t``.

    ``g`` has peak 1 and squared width ``2 shape_std`` (the reference's
    peak-normalized pdf, which differs from the model's footprint).
    Frames are rendered one at a time, over voxel chunks of at most
    ``RENDER_CHUNK`` footprint values.

    Args:
      positions: ``[K, 3, T]``; traces: ``[K, T]``; size: ``(M, N, Z)``.

    Returns:
      ``[T, M, N, Z]`` clean video (no noise, no normalization), on the
      device of ``positions``.
    """
    dev = positions.device
    grid = voxel_grid(size, device=dev)
    k, _, t = positions.shape
    sigma = torch.full((k,), math.sqrt(2.0 * shape_std), dtype=torch.float32,
                       device=dev)
    pos_t = positions.permute(2, 0, 1)  # [T, K, 3]
    traces = torch.as_tensor(traces, dtype=torch.float32, device=dev)
    p = grid.shape[0]
    chunk = max(1, RENDER_CHUNK // max(k, 1))
    video = torch.empty((t, p), dtype=torch.float32, device=dev)
    for i in range(t):
        for s in range(0, p, chunk):
            e = min(s + chunk, p)
            a = gaussian_footprints(grid[s:e], pos_t[i], sigma)
            video[i, s:e] = a @ traces[:, i]
    m, n, z = (int(s) for s in size)
    return video.reshape(t, m, n, z)


def _finish_video(clean: torch.Tensor, noise: torch.Tensor,
                  bg_snr_db: float) -> torch.Tensor:
    """Normalize by the sum of squares (not its root: the reference's
    rule, so the signal's scale falls as ``1 / (T K)`` while the noise's
    does not), add ``noise`` (unit normals) at ``bg_snr_db``, rescale by
    the max."""
    video = clean / torch.sum(clean ** 2)
    bg_std = math.sqrt(10.0 ** (bg_snr_db / 10.0))
    video = video + bg_std * noise
    return video / torch.max(video)


def _positions(config: SimulatorConfig, gen, device) -> torch.Tensor:
    motion = config.motion
    k, t = config.num_neurons, config.num_frames
    if motion in ("sq", "qs"):
        return quadratic_sequential_trajectory(
            gen, k, t, means=config.motion_means,
            snr_db=config.motion_snr_db, size=config.size, device=device)
    if motion == "q":
        return quadratic_trajectory(gen, k, t, snr_db=config.motion_snr_db,
                                    size=config.size, device=device)
    if motion == "gp":
        return gp_motion(gen, k, t, sigma=config.gp_sigma,
                         length_scale=config.gp_length_scale,
                         size=config.size,
                         min_separation=config.min_separation,
                         margin=config.margin, device=device)
    if motion == "gpt":
        return gp_time_motion(gen, k, t, sigma=config.gp_sigma,
                              length_scale=config.gp_length_scale[0],
                              size=config.size,
                              min_separation=config.min_separation,
                              margin=config.margin, device=device)
    raise ValueError(f"unknown motion model: {motion!r}")


def clean_fixture(config: SimulatorConfig, generator: torch.Generator,
                  device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixture before its noise: ``(clean video [T, M, N, Z],
    positions [K, 3, T], traces [K, T])``, drawing the motion, then the
    traces, from ``generator``."""
    positions = _positions(config, generator, device)
    if config.traces != "exp":
        raise ValueError(f"unknown trace model: {config.traces!r}")
    traces = exponential_traces(generator, config.num_neurons,
                                config.num_frames, density=config.density,
                                device=device)
    clean = render_video(positions, traces, config.size, config.shape_std)
    return clean, positions, traces


def generate_video(config: SimulatorConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full fixture: render, normalize by the sum of squares, add Gaussian
    background noise at ``bg_snr_db``, rescale by the max.

    Draws, in order, the motion, the traces and the noise from
    ``generator`` (default ``torch.Generator(device)`` seeded with
    ``config.seed``).

    Returns:
      ``(video [T, M, N, Z], positions [K, 3, T], traces [K, T])`` on
      ``device``.
    """
    if generator is None:
        generator = torch.Generator(torch.device(device)).manual_seed(
            config.seed)
    clean, positions, traces = clean_fixture(config, generator, device)
    noise = _normal(generator, clean.shape, device)
    return _finish_video(clean, noise, config.bg_snr_db), positions, traces


def roi_signals(video: torch.Tensor, positions: torch.Tensor,
                window=(3, 3, 0)) -> torch.Tensor:
    """Cube-mean baseline trace extractor: the mean of the ``(2w+1)``-cube
    around each rounded tracked position.  Out-of-volume voxels count as
    zeros in the mean, as the reference's zero-padded subcube does.

    Args:
      video: ``[T, M, N, Z]``; positions: ``[K, 3, T]``.

    Returns:
      ``[K, T]`` signals.
    """
    t_frames, m, n, z = video.shape
    dev = video.device
    wx, wy, wz = (int(w) for w in window)
    axes = [torch.arange(-w, w + 1, device=dev) for w in (wx, wy, wz)]
    offs = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, 3)  # [W, 3]
    dims = torch.tensor([m, n, z], device=dev)
    centers = torch.round(positions.permute(2, 0, 1)).long()  # [T, K, 3]
    coords = centers[:, :, None, :] + offs[None, None]  # [T, K, W, 3]
    valid = torch.all((coords >= 0) & (coords < dims), dim=-1)
    cc = torch.minimum(torch.clamp_min(coords, 0), dims - 1)
    flat_idx = (cc[..., 0] * n + cc[..., 1]) * z + cc[..., 2]  # [T, K, W]
    vals = torch.gather(video.reshape(t_frames, -1), 1,
                        flat_idx.reshape(t_frames, -1)).reshape(
                            flat_idx.shape)
    s = torch.sum(torch.where(valid, vals, torch.zeros_like(vals)), dim=-1)
    return (s / offs.shape[0]).T


# ----------------------------------------------------------------------
# Auxiliary fixture generators and SNR calculators (host-side NumPy)
# ----------------------------------------------------------------------
def simulate_cell(size4, mean, cov, color, noise_mean, noise_std,
                  trunc_percentile=0.0, seed=None):
    """Render one multi-channel cell volume with peak-normalized
    multivariate-Gaussian intensity.

    Args:
      size4: ``(M, N, Z, C)``; mean: ``[3]``; cov: ``[3, 3]``;
      color/noise_mean/noise_std: per-channel scalars ``[C]``;
      trunc_percentile: zero out intensities below this percentile.
    """
    m, n, z, c = (int(s) for s in size4)
    grid = np.stack(
        np.meshgrid(np.arange(m), np.arange(n), np.arange(z),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3).astype(np.float64)
    diff = grid - np.asarray(mean, dtype=np.float64)
    prec = np.linalg.inv(np.asarray(cov, dtype=np.float64))
    expo = -0.5 * np.einsum("pi,ij,pj->p", diff, prec, diff)
    p = np.exp(expo)  # peak-normalized
    if p.size > 1 and trunc_percentile > 0:
        p[p < np.percentile(p, trunc_percentile)] = 0.0
    prob = p.reshape(m, n, z)
    out = np.zeros((m, n, z, c))
    rng = np.random.default_rng(seed)  # None -> fresh entropy per call
    for ch in range(c):
        out[..., ch] = (color[ch] * prob + noise_mean[ch]
                        + noise_std[ch] * rng.standard_normal((m, n, z)))
    return out


def unit_vector(data, axis=None):
    """Normalize by the Euclidean norm along ``axis``."""
    data = np.asarray(data, dtype=np.float64)
    if axis is None and data.ndim == 1:
        return data / np.sqrt(np.dot(data, data))
    length = np.sqrt(np.sum(data * data, axis=axis, keepdims=True))
    return data / length


def rotation_matrix(angle, direction):
    """4x4 rotation about an axis direction (Rodrigues form)."""
    d = unit_vector(np.asarray(direction[:3], dtype=np.float64))
    s, c = np.sin(angle), np.cos(angle)
    rot = c * np.eye(3) + (1 - c) * np.outer(d, d) + s * np.array(
        [[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]]
    )
    out = np.eye(4)
    out[:3, :3] = rot
    return out


def generate_random_video(
    cellnum=10, rnd_pos=True, rnd_rot=True, trunc=60.0,
    size=(64, 64, 1, 3, 32), cell_size=(15, 15, 1, 3),
    cov=((7, 0, 0), (0, 2, 0), (0, 0, 1e-6)), noise_std=1.0, seed=0,
):
    """Rotating-cell fixture video: random-walking, rotating anisotropic
    cells composited into a noisy multi-channel volume sequence.

    Returns ``(video [M,N,Z,C,T], trajectory [T,cellnum,3],
    rotations [T,cellnum,3], colors [cellnum,C])``.
    """
    rng = np.random.default_rng(seed)
    size = np.asarray(size)
    cell_size = np.asarray(cell_size)
    cov = np.asarray(cov, dtype=np.float64)
    border = np.maximum(size[:3] - cell_size[:3], 0)
    centers = (cell_size[:3] - 1) / 2.0 + rng.random(
        (cellnum, 3)
    ) * border

    t_frames = int(size[4])
    if rnd_pos:
        steps = rng.multivariate_normal(
            np.zeros(3), [[3.0, 0.3, 0], [0.3, 1.4, 0], [0, 0, 1e-6]],
            size=(t_frames, cellnum),
        )
        trajectory = (np.cumsum(steps, axis=0)
                      + centers[None]).astype(int)
    else:
        trajectory = np.tile(centers.astype(int), (t_frames, 1, 1))
    trajectory[trajectory < 0] = 0

    colors = rng.random((cellnum, int(size[3])))
    colors = colors / colors.sum()
    video = noise_std * rng.random(tuple(size))
    center = (cell_size[:3] / 2).astype(int)

    if rnd_rot:
        rot = np.cumsum(
            rng.multivariate_normal(np.zeros(3), 0.01 * np.eye(3),
                                    size=(t_frames, cellnum)),
            axis=0,
        )
    else:
        rot = np.tile(
            rng.multivariate_normal(np.zeros(3), np.eye(3),
                                    size=(1, cellnum)),
            (t_frames, 1, 1),
        )

    for k in range(cellnum):
        for t in range(t_frames):
            rt = rotation_matrix(rot[t, k, 0], [0, 0, 1])[:3, :3]
            rcov = rt.T @ cov @ rt
            cell = simulate_cell(
                tuple(cell_size), center, rcov, colors[k],
                np.zeros(int(size[3])), np.zeros(int(size[3])), trunc,
            )
            video[:, :, :, :, t] += placement(
                tuple(size[:3]), trajectory[t, k], cell
            )
    video = video / video.max()
    return video, trajectory, rot, colors


def compute_snr_intensity(density, cov=None, num_frames=20,
                          bg_std=1e-4, seed=0):
    """Cell-activity SNR from trace/footprint peaks vs the noise std.  The
    mean trace peak is taken over 10 single-neuron draws of
    :func:`exponential_traces` from a CPU generator seeded ``seed``."""
    if cov is None:
        cov = 2 * np.eye(3)
    cov = np.asarray(cov, dtype=np.float64)
    gen = torch.Generator().manual_seed(seed)
    max_c = float(np.mean([
        float(torch.max(exponential_traces(gen, 1, num_frames, density,
                                           device="cpu")))
        for _ in range(10)
    ]))
    center = (np.sqrt(np.linalg.eigvals(cov).real) * 3).astype(int)
    sz4 = tuple(center * 2) + (1,)
    max_a = simulate_cell(sz4, center.tolist(), cov, [1.0], [0.0],
                          [0.0]).max()
    return 2 * (np.log10(max_c) + np.log10(max_a) - np.log10(bg_std))


def compute_snr_motion(stds=(1e-3, 1e-3, 1e-5)):
    """Motion SNR of the quadratic coefficients vs identity."""
    b0 = np.zeros((3, 10))
    b0[0, 1] = b0[1, 2] = b0[2, 3] = 1.0
    noise_power = sum(s**2 for s in stds) * b0.size / 3
    return float(np.log((b0**2).sum()) - np.log(noise_power))


def compute_snr_positions(positions):
    """Position SNR: frame-0 energy vs mean drift energy; ``positions [K,
    3, T]`` as an array or a tensor on any device."""
    p = as_numpy(positions)
    num = (p[:, :, 0] ** 2).sum()
    drift = np.mean([
        ((p[:, :, t] - p[:, :, 0]) ** 2).sum()
        for t in range(1, p.shape[2])
    ])
    return float(np.log(num) - np.log(drift))


def simulate_trajectory(num_frames, num_objects, mean, cov, seed=0):
    """Random-walk trajectories: cumulative multivariate-normal steps plus
    per-object mean offsets.  Returns ``[T, num_objects, 3]``."""
    rng = np.random.default_rng(seed)
    steps = rng.multivariate_normal(
        np.zeros(3), np.asarray(cov, dtype=np.float64),
        size=(num_frames, num_objects),
    )
    traj = np.cumsum(steps, axis=0)
    return traj + np.asarray(mean, dtype=np.float64)[None, :, :]
