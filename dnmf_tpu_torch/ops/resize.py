"""Per-axis matrices of ``jax.image.resize(..., method="cubic")``.

The resize is linear and separable, so its action along one axis is a
``[size, g]`` matrix.  The piecewise-rigid shift field is upsampled with
it (:func:`upsample_field`, in the registration's remap and DFT paths)
and kernel G evaluates the field from it (:mod:`dnmf_tpu_torch.ops.warp`).

``torch.nn.functional.interpolate(mode="bicubic")`` is a different map
(``a = -0.75``, clamped taps): for a 4 -> 512 resize its weights differ
from these by up to 0.065, so it is not used.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with ``a = -0.5`` at ``x >= 0``."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


@functools.lru_cache(maxsize=64)
def _resize_matrix64(g: int, size: int) -> np.ndarray:
    if g == 1:
        return np.ones((size, 1))
    inv_scale = g / size
    # Half-pixel centres; the kernel widens only when downsampling.
    sample = (np.arange(size) + 0.5) * inv_scale - 0.5
    kernel_scale = max(inv_scale, 1.0)
    w = _keys_cubic(np.abs(sample[:, None] - np.arange(g)[None, :])
                    / kernel_scale)
    # Taps outside [0, g) are absent; the rest are renormalised to sum 1.
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0.0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= g - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resize_matrix(g: int, size: int, dtype=np.float32) -> np.ndarray:
    """``[size, g]`` matrix of the cubic resize of an axis of length ``g``
    to ``size`` (``g == 1`` broadcasts; ``g == size`` is the identity)."""
    return _resize_matrix64(int(g), int(size)).astype(dtype)


# Unbounded: a captured graph reads these tensors at their addresses, so
# none may be dropped while the process runs (one per axis shape).
@functools.cache
def device_matrix(g: int, size: int, dtype, device) -> torch.Tensor:
    """:func:`resize_matrix` (made in float64) as a ``dtype`` tensor on
    ``device``, made once per shape: after the first call no host copy is
    made (:mod:`dnmf_tpu_torch.models.graphs` captures its users)."""
    return torch.as_tensor(resize_matrix(g, size, np.float64), dtype=dtype,
                           device=device)


def upsample_field(field: torch.Tensor, grid_shape, new_shape) -> torch.Tensor:
    """Cubic upsampling of patch-grid fields ``[*batch, prod(grid_shape)]``
    to ``[*batch, *new_shape]`` (``jax.image.resize(..., "cubic")`` per
    field; a grid of singletons broadcasts)."""
    batch = tuple(field.shape[:-1])
    nd = len(grid_shape)
    out = field.reshape(batch + tuple(grid_shape))
    if all(g == 1 for g in grid_shape):
        return out.expand(batch + tuple(new_shape))
    for d, (g, size) in enumerate(zip(grid_shape, new_shape)):
        if g == size:
            continue  # jax.image.resize leaves equal axes alone
        r = device_matrix(g, size, out.dtype, out.device)
        ax = out.ndim - nd + d
        out = torch.matmul(out.movedim(ax, -1), r.T).movedim(-1, ax)
    return out
