"""Kernel F's FFT plan (``dnmf_tpu_torch/ops/phasecorr.py``) on the CPU.

``csrc/phasecorr.cu`` transforms every axis by a mixed-radix Stockham
FFT whose radices come from :func:`phasecorr.fft_plan` and whose twiddles
come from :func:`phasecorr.fft_twiddles`.  The kernel runs only on the
card; here the plan, the table and a NumPy emulation of the kernel's
stages, in its order and index convention, are held against NumPy's FFT,
and the plain version against the JAX kernel at odd and prime lengths.

Tolerances: twiddles within half a float32 ulp of float64 (they are the
float64 table rounded once); the emulated FFT within 1e-5 of the float64
FFT's max magnitude (float32 butterflies); product spectra 1e-4 relative
(float32 FFTs in another order), shifts exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import pallas_phasecorr as jpp
from dnmf_tpu_torch.ops import phasecorr

LENGTHS = (1, 2, 3, 7, 10, 13, 20, 97, 128, 160, 264)


def stockham(x, plan, tw):
    """The kernel's ``fft_lines`` on the rows of ``x``, in complex64.

    A radix-R stage after stages of product ``ns``: butterfly ``j`` (``k =
    j mod ns``) reads ``x[j + r L/R] * tw[r k L / (ns R)]``, takes the
    R-point DFT (its twiddles ``tw[(r q mod R) L/R]``) and writes output
    ``q`` to ``x[(j - k) R + k + q ns]``."""
    length = x.shape[-1]
    a = x.astype(np.complex64)
    ns = 1
    for radix in plan:
        lr, stride = length // radix, length // (ns * radix)
        r = np.arange(radix)
        dft = tw[(r[:, None] * r[None] % radix) * lr]  # [r, q]
        b = np.empty_like(a)
        for j in range(lr):
            k = j % ns
            v = a[:, j + r * lr] * tw[r * k * stride]
            b[:, (j - k) * radix + k + r * ns] = v @ dft
        a = b
        ns *= radix
    return a


def _table(length):
    tw = phasecorr.fft_twiddles(length, "cpu").numpy()
    return (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)


@pytest.mark.parametrize("length", LENGTHS)
def test_plan_radices_multiply_to_length(length):
    plan = phasecorr.fft_plan(length)
    assert math.prod(plan) == length
    assert len(plan) <= phasecorr.MAX_STAGES
    generic = [r for r in plan if r not in phasecorr.SPECIALISED]
    assert generic == sorted(generic)
    for r in generic:  # generic radices are primes
        assert all(r % d for d in range(2, math.isqrt(r) + 1))


def test_plan_of_the_repo_lengths_is_specialised():
    """Patch lengths of the repo's grids take only specialised
    butterflies; odd primes take the generic one."""
    for length, plan in ((10, (2, 5)), (20, (4, 5)), (128, (8, 8, 2)),
                         (160, (8, 4, 5)), (264, (8, 11, 3))):
        assert phasecorr.fft_plan(length) == plan
    assert phasecorr.fft_plan(1) == ()
    assert phasecorr.fft_plan(91) == (7, 13)
    assert phasecorr.fft_plan(67) == (67,)
    with pytest.raises(ValueError):
        phasecorr.fft_plan(0)


@pytest.mark.parametrize("length", LENGTHS)
def test_twiddles_match_float64(length):
    tw = phasecorr.fft_twiddles(length, "cpu")
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (length, 2)
    ref = np.exp(-2j * np.pi * np.arange(length) / length)
    np.testing.assert_allclose(tw[:, 0].numpy(), ref.real, rtol=0,
                               atol=2.0 ** -25)
    np.testing.assert_allclose(tw[:, 1].numpy(), ref.imag, rtol=0,
                               atol=2.0 ** -25)
    # One table per (length, device): later calls copy nothing.
    assert phasecorr.fft_twiddles(length, "cpu") is tw


@pytest.mark.parametrize("length", LENGTHS)
def test_stockham_emulation_matches_numpy_fft(rng, length):
    x = rng.normal(size=(3, length)) + 1j * rng.normal(size=(3, length))
    got = stockham(x, phasecorr.fft_plan(length), _table(length))
    ref = np.fft.fft(x, axis=-1)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_tiles_fit_shared_memory():
    per = phasecorr.SMEM_BYTES // 8
    for m, n, z in ((264, 264, 20), (160, 160, 10), (128, 128, 10),
                    (97, 67, 13), (1, 1, 1)):
        rb, cc, cw = phasecorr.fft_tiles(m, n, z)
        assert n + 2 * -(-rb // 2) * n <= per and rb * n <= max(
            n, phasecorr.ROW_ELEMS)
        assert m + 2 * m * cc <= per and cc <= min(phasecorr.COLS, n)
        assert z + n + 3 * z * cw <= per and cw <= n
    assert phasecorr.fft_tiles(264, 264, 20) == (31, 16, 132)
    assert phasecorr.fft_tiles(64, 2048, 32)[2] < 2048  # n in chunks
    with pytest.raises(ValueError):
        phasecorr.fft_tiles(20000, 16, 4)


@pytest.mark.parametrize("shape", [(13, 11, 3), (7, 9, 1), (10, 20, 5)])
def test_phase_corr_plain_matches_pallas_at_odd_lengths(rng, shape):
    """The plain version (the kernel's CPU path and card-side check)
    against the JAX kernel at odd and prime axis lengths and z = 1."""
    m, n, z = shape
    np_, b = 2, 3
    tmpl = rng.random((np_, m, n, z)).astype(np.float32)
    true = rng.integers(-2, 3, (b, np_, 3))
    true[..., 2] = rng.integers(-1, 2, (b, np_)) if z > 1 else 0
    pats = np.stack([[np.roll(tmpl[p], tuple(true[i, p]), (0, 1, 2))
                      for p in range(np_)] for i in range(b)])
    pats = (pats + 0.01 * rng.random(pats.shape)).astype(np.float32)
    bounds = np.zeros((b, 8), np.float32)
    bounds[:, :3] = [-3, -3, -1]
    bounds[:, 3:6] = [4, 4, 2]
    tre, tim = jpp.patch_spectra(jnp.asarray(tmpl))
    r_s, r_re, r_im = jpp.phase_corr_block(
        jpp.to_zm_n(jnp.asarray(pats)), tre, tim, jnp.asarray(bounds), z=z,
        precision="highest", interpret=True)
    t_re, t_im = phasecorr.patch_spectra(torch.from_numpy(tmpl))
    g_s, g_re, g_im = phasecorr.phase_corr_block(
        phasecorr.to_zm_n(torch.from_numpy(pats)), t_re, t_im,
        torch.from_numpy(bounds), z=z)
    np.testing.assert_array_equal(g_s.numpy(), np.asarray(r_s))
    np.testing.assert_array_equal(g_s.numpy(), true)
    ref = np.asarray(r_re) + 1j * np.asarray(r_im)
    got = g_re.numpy() + 1j * g_im.numpy()
    assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))
