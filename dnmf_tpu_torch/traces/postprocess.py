"""Trace post-processing: histogram matching, outlier damping,
de-bleaching, dF/F0, interpolation, smoothing, rescaling.

The reference file (``Demix/Traces.py``) does not parse —
from line 107 it is literal MATLAB, ``histogram_match`` has a stray
``@staticmethod`` and a shape-broken design matrix (SURVEY.md §2.4 #9) —
so this module implements the *documented intent* (its docstrings +
MATLAB body, ``:52-257``) as working, tested code.  These run host-side
(NumPy/SciPy): trace cleanup is a tiny post-processing step, not a hot
path on the card.  The port's copy of ``dnmf_tpu/traces/postprocess.py``;
traces may be NumPy arrays or torch tensors on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dnmf_tpu_torch.utils.volume import as_numpy


def histogram_match(
    a: np.ndarray,
    b: np.ndarray,
    nbins: int,
    kind: str = "non-negative",
) -> Tuple[np.ndarray, float]:
    """Affinely map trace ``a`` so its quantile profile matches ``b``.

    Reference ``histogram_match`` (``Demix/Traces.py:11-48``)
    with its broken design-matrix concatenation fixed: the matching
    quantiles are regressed ``b_q ~ beta0 * a_q + beta1`` (non-negative
    least squares for ``kind="non-negative"``, ordinary LS otherwise) and
    the affine map is applied to ``a``.

    Returns:
      ``(a_transform, distance)`` — transformed trace with NaNs restored,
      and the RMS distance between the matched quantile profiles (the
      reference returned NaN here; a real value is strictly more useful).
    """
    a = as_numpy(a, np.float64)
    b = as_numpy(b, np.float64)
    a_ok = ~np.isnan(a)
    b_ok = ~np.isnan(b)
    av, bv = a[a_ok], b[b_ok]

    q = np.linspace(0, 1, nbins)
    abins = np.quantile(av, q)
    bbins = np.quantile(bv, q)

    design = np.stack([abins, np.ones_like(abins)], axis=1)
    if kind == "non-negative":
        from scipy.optimize import nnls

        beta, _ = nnls(design, bbins)
    elif kind == "regular":
        beta, *_ = np.linalg.lstsq(design, bbins, rcond=None)
    else:
        raise ValueError(f"unknown kind: {kind!r}")

    out = np.full(a.shape, np.nan)
    out[a_ok] = av * beta[0] + beta[1]
    distance = float(
        np.sqrt(np.mean((abins * beta[0] + beta[1] - bbins) ** 2))
    )
    return out, distance


def _medfilt_nan(x: np.ndarray, k: int) -> np.ndarray:
    """Centered running median ignoring NaNs (MATLAB
    ``medfilt1(..., 'omitnan')`` analog)."""
    if k < 2:
        return x.copy()
    n = x.shape[-1]
    half = k // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)],
                    constant_values=np.nan)
    windows = np.stack(
        [padded[..., i:i + n] for i in range(k)], axis=-1
    )
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmedian(windows, axis=-1)


def _fit_exponential(x: np.ndarray, y: np.ndarray):
    """Fit ``y ~ a * exp(b * x)`` (MATLAB ``fit(..., 'exp1')`` analog).

    Log-linear initialization + Levenberg-Marquardt refinement; returns
    ``(a, b)`` or ``None`` if the fit fails.
    """
    from scipy.optimize import curve_fit

    pos = y > 0
    if pos.sum() < 3:
        return None
    b0, loga0 = np.polyfit(x[pos], np.log(y[pos]), 1)
    try:
        popt, _ = curve_fit(
            lambda t, a, b: a * np.exp(b * t), x, y,
            p0=(np.exp(loga0), b0), maxfev=2000,
        )
        return float(popt[0]), float(popt[1])
    except (RuntimeError, ValueError):
        return None


def clean_traces(
    traces: np.ndarray,
    fps: float,
    sigma_threshold: Optional[float] = 10.0,
    detrend_mode: int = 2,
    interp_method: Optional[str] = None,
    smooth_method: Optional[str] = None,
    smooth_window=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clean neural traces: outliers, bleaching, scaling to [0.05, 0.95].

    Implements the intent of the reference ``cleanTraces``
    (``Demix/Traces.py:52-257``):

      1. NaN the first ``fps/2`` frames, the last frame, and values
         <= 0.01.
      2. Dampen single-frame extreme outliers (a jump beyond
         ``sigma_threshold`` stds immediately reversed), then 3-point
         median filter.
      3. De-bleach: ``detrend_mode`` 0 = none, 1 = global exponential
         bleach curve, 2 = per-neuron curves, 3 = per-neuron curves +
         dF/F0 with F0 the 5th percentile (median across neurons,
         clamped >= 1).
      4. Optionally interpolate NaNs (``interp_method="linear"``).
      5. Optionally smooth (``"low"``/``"high"`` Butterworth,
         ``"causal"`` causal bandpass, ``"movmean"`` moving average;
         ``smooth_window`` holds the cutoff(s)/window).
      6. For ``detrend_mode < 3``: rescale each trace to [0, 1] and then
         into [0.05, 0.95].

    Returns:
      ``(traces, scales, offsets)`` such that the original is
      approximately ``cleaned * scales + offsets`` per neuron.
    """
    traces = np.array(as_numpy(traces), dtype=np.float64)
    k, t = traces.shape
    x = np.arange(t, dtype=np.float64)

    # 1. Edge frames and dead values.
    head = int(round(fps / 2))
    traces[:, :head] = np.nan
    traces[:, -1] = np.nan
    traces[traces <= 0.01] = np.nan

    # 2. Extreme single-frame outliers.
    if sigma_threshold:
        thr = sigma_threshold * np.nanstd(traces, axis=1) + np.nanmean(
            traces, axis=1
        )
        d = np.diff(traces, axis=1)
        up = d > thr[:, None]
        dn = d < -thr[:, None]
        spike = (up[:, :-1] & dn[:, 1:]) | (dn[:, :-1] & up[:, 1:])
        nk, nt = np.where(spike)
        traces[nk, nt + 1] = np.nan
        traces = _medfilt_nan(traces, 3)

    offsets = np.zeros(k)
    detrend_offsets = np.zeros(k)
    scales = np.ones(k)

    if detrend_mode > 0:
        tr_nan = traces.copy()
        tr_nan[tr_nan <= 0.1] = np.nan
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            f0 = np.nanpercentile(tr_nan, 5, axis=1)
        filt_order = max(int(round(10 * fps)), 1)
        detrend_threshold = 0.1 * t

        if detrend_mode == 1:
            # Global bleach curve on [0,1]-scaled traces.
            offsets = np.nanmin(traces, axis=1)
            traces = traces - offsets[:, None]
            scales = np.nanmax(traces, axis=1)
            traces = traces / scales[:, None]
            y = np.nanmean(traces, axis=0)
            y_filt = _medfilt_nan(y[None], filt_order)[0]
            ok = ~np.isnan(y_filt)
            if ok.sum() > detrend_threshold:
                fit = _fit_exponential(x[ok], y_filt[ok])
                if fit is not None and fit[1] < 0:
                    a, b = fit
                    traces = traces - a * np.exp(b * x)[None, :]
                    detrend_offsets[:] = a
        else:
            for i in range(k):
                yi_filt = _medfilt_nan(traces[i][None], filt_order)[0]
                ok = ~np.isnan(yi_filt)
                if ok.sum() > detrend_threshold:
                    fit = _fit_exponential(x[ok], yi_filt[ok])
                    if fit is not None and fit[1] < 0:
                        a, b = fit
                        traces[i] = traces[i] - a * np.exp(b * x)
                        detrend_offsets[i] = a

        if detrend_mode == 3:
            f0_all = np.full(k, np.nanmedian(f0))
            scales = np.maximum(f0_all, 1.0)
            offsets = np.zeros(k)
            traces = traces / scales[:, None]

    # 4. Interpolation.
    if interp_method:
        for i in range(k):
            bad = np.isnan(traces[i])
            if bad.all() or not bad.any():
                continue
            good = ~bad
            traces[i, bad] = np.interp(x[bad], x[good], traces[i, good])

    # 5. Smoothing.
    if smooth_method and smooth_window is not None:
        from scipy import signal

        # Butterworth/moving filters propagate NaN across the whole row
        # (step 1 always NaNs the edge frames), so interpolate any
        # remaining gaps first.
        for i in range(k):
            bad = np.isnan(traces[i])
            if bad.any() and not bad.all():
                good = ~bad
                traces[i, bad] = np.interp(x[bad], x[good],
                                           traces[i, good])

        sw = np.atleast_1d(smooth_window).astype(float)
        if smooth_method == "low":
            b, a = signal.butter(int(sw[0]), sw[1], btype="low")
            traces = signal.filtfilt(b, a, traces, axis=1)
        elif smooth_method == "high":
            b, a = signal.butter(int(sw[0]), sw[1], btype="high")
            traces = signal.filtfilt(b, a, traces, axis=1)
        elif smooth_method == "causal":
            b, a = signal.butter(int(sw[0]), [sw[1], sw[2]], btype="band")
            traces = signal.lfilter(b, a, traces, axis=1)
        elif smooth_method == "movmean":
            w = int(sw[0])
            kernel = np.ones(w) / w
            traces = np.stack(
                [np.convolve(tr, kernel, mode="same") for tr in traces]
            )
        else:
            raise ValueError(f"unknown smooth method: {smooth_method!r}")

    # 6. Rescale to [0.05, 0.95].
    if detrend_mode < 3:
        new_offsets = np.nanmin(traces, axis=1)
        traces = traces - new_offsets[:, None]
        new_scales = np.nanmax(traces, axis=1)
        new_scales[new_scales == 0] = 1.0
        traces = traces / new_scales[:, None]
        offsets = offsets + (detrend_offsets + new_offsets) * scales
        scales = scales * new_scales
        # Fold the [0.05, 0.95] remap into the returned affine so that
        # original ~= cleaned * scales + offsets stays exact.
        traces = traces * 0.9 + 0.05
        scales = scales / 0.9
        offsets = offsets - 0.05 * scales

    return traces, scales, offsets
