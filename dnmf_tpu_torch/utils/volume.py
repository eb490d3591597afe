"""Volume/patch utilities (host-side NumPy; not on the card's hot path).

The port's copy of ``dnmf_tpu/utils/volume.py``, equivalents of the
reference ``WUtils/Utils.py``: padded sub-cube extraction around
fractional 3-D locations, patch placement/superposition with boundary
clipping, max projections, pairwise distances.  Arrays may be NumPy
arrays or torch tensors on any device (:func:`as_numpy`).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import shift as nd_shift


def as_numpy(x, dtype=None) -> np.ndarray:
    """A NumPy array of ``x``: a tensor on any device goes through
    ``.cpu().numpy()``, anything else through ``np.asarray``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def subcube(cube, loc, radius):
    """Extract a zero-padded ``(2r+1)``-cube around a fractional location.

    Equivalent of ``Utils.subcube`` (``WUtils/Utils.py:14-52``):
    the window is centered at ``round(loc)`` spatially, values are
    sub-pixel shifted by the fractional part, and out-of-volume regions
    are zero.

    Args:
      cube: ``[M, N, Z]`` or ``[M, N, Z, C]`` volume.
      loc: ``[3]`` fractional center.
      radius: ``[3]`` window half-sizes (ints).

    Returns:
      ``[2r0+1, 2r1+1, 2r2+1, (C)]`` patch.
    """
    cube = as_numpy(cube)
    squeeze = cube.ndim == 3
    if squeeze:
        cube = cube[..., None]
    loc = as_numpy(loc, np.float64)
    radius = np.asarray(radius, dtype=int)
    loc_i = loc.astype(int)
    frac = loc - loc_i

    out_shape = tuple(2 * radius + 1) + (cube.shape[3],)
    patch = np.zeros(out_shape, dtype=cube.dtype)

    lo = np.maximum(loc_i - radius, 0)
    hi = np.minimum(loc_i + radius + 1, np.array(cube.shape[:3]))
    if np.any(lo >= hi):
        return patch[..., 0] if squeeze else patch
    dst_lo = lo - (loc_i - radius)
    dst_hi = dst_lo + (hi - lo)
    patch[dst_lo[0]:dst_hi[0], dst_lo[1]:dst_hi[1], dst_lo[2]:dst_hi[2]] = (
        cube[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    )
    if np.any(frac != 0):
        # Reference uses scipy.ndimage.affine_transform(eye(3), offset=frac)
        # whose default interpolation is a cubic (order-3) spline with
        # zero-fill (WUtils/Utils.py:38,42); nd_shift(-frac)
        # applies the same output[i] = input[i + frac] resampling.
        for ch in range(patch.shape[3]):
            patch[..., ch] = nd_shift(patch[..., ch], -frac, order=3)
    return patch[..., 0] if squeeze else patch


def placement(size, loc, patch):
    """Place a patch into a zero volume centered at ``loc`` with boundary
    clipping (``Utils.placement``, ``WUtils/Utils.py:54-75``)."""
    return _paste(size, loc, patch)


def superpose(volume, loc, patch):
    """Additively place a patch (``Utils.superpose``, ``:78-101``).

    Note: like the reference, the patch is added into a fresh zero volume
    (the input volume supplies only the shape)."""
    return _paste(as_numpy(volume).shape[:3], loc, patch)


def _paste(size, loc, patch):
    patch = as_numpy(patch)
    squeeze = patch.ndim == 3
    if squeeze:
        patch = patch[..., None]
    size = tuple(int(s) for s in size)
    loc = np.floor(as_numpy(loc)).astype(int)
    center = (np.array(patch.shape[:3]) // 2).astype(int)

    out = np.zeros(size + (patch.shape[3],), dtype=patch.dtype)
    lo = np.maximum(loc - center, 0)
    hi = np.minimum(loc + center + 1, np.array(size))
    if np.any(lo >= hi):
        return out[..., 0] if squeeze else out
    src_lo = lo - (loc - center)
    src_hi = src_lo + (hi - lo)
    out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = patch[
        src_lo[0]:src_hi[0], src_lo[1]:src_hi[1], src_lo[2]:src_hi[2]
    ]
    return out[..., 0] if squeeze else out


def max_project(video, color_by_depth=False, cut_points=None):
    """Max-project over z, optionally binning depth into RGB channels
    (``Utils.max_project``, ``WUtils/Utils.py:103-118``).

    Args:
      video: ``[M, N, Z, T]`` (or ``[M, N, Z, T, extra]`` reduced over
        the last axis first).
    """
    mp = as_numpy(video)
    if mp.ndim == 5:
        mp = mp.max(4)
    mp = (mp - mp.min()) / (mp.max() - mp.min() + 1e-32)
    if color_by_depth:
        c0, c1 = cut_points
        return np.stack(
            [
                mp[:, :, :c0, :].max(2).squeeze(),
                mp[:, :, c0 + 1:c1, :].max(2).squeeze(),
                mp[:, :, c1 + 1:, :].max(2).squeeze(),
            ],
            axis=-1,
        )
    return mp.max(2).squeeze()


def pairwise_distances(x, y):
    """Squared Euclidean distance matrix (``Utils.pairwise_distances``,
    ``WUtils/Utils.py:121-125``)."""
    x = as_numpy(x, np.float64)
    y = as_numpy(y, np.float64)
    x2 = (x**2).sum(1)[:, None]
    y2 = (y**2).sum(1)[None, :]
    return x2 + y2 - 2.0 * x @ y.T
