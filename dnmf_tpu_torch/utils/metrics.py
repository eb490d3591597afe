"""Accuracy metrics: R^2 between trace sets, correlation matching.

The port's copy of ``dnmf_tpu/utils/metrics.py``; trace sets may be
NumPy arrays or torch tensors on any device.

NMF traces carry a global (and under some models per-neuron) scale
ambiguity, so the default R^2 fits an affine map per neuron before
scoring — matching how trace-recovery quality is judged against ground
truth.  ``affine=False`` scores raw values (used for parity gates against
another implementation of the same algorithm).
"""

from __future__ import annotations

import numpy as np

from dnmf_tpu_torch.utils.volume import as_numpy


def r_squared(estimate, target, affine: bool = True) -> np.ndarray:
    """Per-row R^2 of ``estimate`` against ``target`` (both ``[K, T]``).

    With ``affine=True``, each row of ``estimate`` is first least-squares
    mapped ``a*x + b`` onto the target row.
    """
    est = as_numpy(estimate, np.float64)
    tgt = as_numpy(target, np.float64)
    if est.ndim == 1:
        est, tgt = est[None], tgt[None]
    out = np.zeros(est.shape[0])
    for k in range(est.shape[0]):
        x, y = est[k], tgt[k]
        if affine:
            a = np.vstack([x, np.ones_like(x)]).T
            coef, *_ = np.linalg.lstsq(a, y, rcond=None)
            x = a @ coef
        ss_res = ((y - x) ** 2).sum()
        ss_tot = ((y - y.mean()) ** 2).sum()
        out[k] = 1.0 - ss_res / ss_tot if ss_tot > 0 else float(ss_res == 0)
    return out


def trace_correlations(estimate, target) -> np.ndarray:
    """Per-row Pearson correlation between two ``[K, T]`` trace sets."""
    est = as_numpy(estimate, np.float64)
    tgt = as_numpy(target, np.float64)
    out = np.zeros(est.shape[0])
    for k in range(est.shape[0]):
        sx, sy = est[k].std(), tgt[k].std()
        if sx == 0 or sy == 0:
            out[k] = 0.0
        else:
            out[k] = np.corrcoef(est[k], tgt[k])[0, 1]
    return out
