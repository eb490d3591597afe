"""The port's registration stack against ``dnmf_tpu`` on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.
Where the JAX side reaches kernel F or G it runs the Pallas kernel as its
own tests do (``interpret=True``, ``precision="highest"``); the port's
wrappers take their plain versions on CPU tensors.

Tolerances: resize matrices 1e-6 (float32 weights); shifts 1e-4 px
(subpixel shifts are multiples of 0.1 px, so a miss is a whole step);
images, templates, movies and product spectra 1e-4 relative to the
reference's max magnitude (float32 FFTs in another order), NaN positions
equal; resampling 1e-5; the fused warp rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dnmf_tpu import config as jcfg
from dnmf_tpu.ops import fft_reg as jF
from dnmf_tpu.ops import interp as jI
from dnmf_tpu.ops import pallas_phasecorr as jpp
from dnmf_tpu.ops import resample as jR
from dnmf_tpu.ops.pallas_warp import fused_separable_warp as j_fused_warp
from dnmf_tpu.registration import MotionCorrect as jMC
from dnmf_tpu.registration import motion_correct as jmc
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.ops import fft_reg as tF
from dnmf_tpu_torch.ops import fused, phasecorr, resize, warp
from dnmf_tpu_torch.ops import interp as tI
from dnmf_tpu_torch.ops import resample as tR
from dnmf_tpu_torch.registration import MotionCorrect as tMC
from dnmf_tpu_torch.registration import motion_correct as tmc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel(got, ref, tol=1e-4):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = max(float(np.max(np.abs(ref[~nan]), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(got[~nan] - ref[~nan]), initial=0.0))
    assert err <= tol * scale, f"{err:.3e} > {tol} x {scale:.3e}"


def _template(rng, shape, sigma=2.0):
    return gaussian_filter(rng.normal(size=shape), sigma).astype(np.float32)


def _shifted(tmpl, shifts):
    return np.stack([np.asarray(jF.apply_shifts_fourier(
        jnp.asarray(tmpl), jnp.asarray(s, jnp.float32), border_nan=False))
        for s in shifts]).astype(np.float32)


# ------------------------------------------------------------ resize
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5])
def test_resize_matrix_matches_jax(g):
    """``jax.image.resize`` itself at a spread of sizes, and every size
    6..64 through ``jax.image.scale_and_translate`` with the resize's
    scale (one compile: the scale is traced; row i of the weights does
    not depend on the output length)."""
    eye = jnp.eye(g, dtype=jnp.float32)
    for size in (6, 7, 16, 33, 64):
        ref = np.asarray(jax.image.resize(eye, (size, g), "cubic"))
        np.testing.assert_allclose(resize.resize_matrix(g, size), ref,
                                   rtol=0, atol=1e-6)

    @jax.jit
    def rows(scale):
        return jax.image.scale_and_translate(
            eye, (64, g), (0,), scale[None], jnp.zeros(1), "cubic")

    for size in range(6, 65):
        ref = (np.ones((size, 1)) if g == 1
               else np.asarray(rows(jnp.float32(size / g)))[:size])
        np.testing.assert_allclose(resize.resize_matrix(g, size), ref,
                                   rtol=0, atol=1e-6)


def test_upsample_field_matches_jax(rng):
    for grid, new in [((3, 4, 2), (20, 24, 6)), ((1, 3, 1), (12, 16, 5)),
                      ((1, 1, 1), (8, 8, 3)), ((2, 3), (9, 14))]:
        f = rng.normal(size=(2, int(np.prod(grid)))).astype(np.float32)
        ref = np.stack([np.asarray(jmc._upsample_field(jnp.asarray(x), grid,
                                                       new)) for x in f])
        got = resize.upsample_field(torch.from_numpy(f), grid, new)
        assert_rel(got, ref, 1e-6)


# ----------------------------------------------------------- fft_reg
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("usf", [1, 10])
@pytest.mark.parametrize("window", ["max_shifts", "bounds", "none"])
def test_phase_cross_correlation_matches_jax(rng, nd, usf, window):
    shape = (24, 20) if nd == 2 else (20, 16, 6)
    tmpl = _template(rng, shape)
    true = ([2.3, -1.7] if nd == 2 else [2.3, -1.7, 0.6])
    src = _shifted(tmpl, [true])[0]
    kw = {}
    if window == "max_shifts":
        kw = dict(max_shifts=(4,) * nd)
    elif window == "bounds":
        kw = dict(shifts_lb=[-1.0, -3.0, 0.0][:nd],
                  shifts_ub=[4.0, 1.0, 2.0][:nd])
    ref_s, _, ref_dp = jF.phase_cross_correlation(
        jnp.asarray(src), jnp.asarray(tmpl), upsample_factor=usf,
        **{k: (jnp.asarray(v) if k.startswith("shifts") else v)
           for k, v in kw.items()})
    got_s, got_f, got_dp = tF.phase_cross_correlation(
        torch.from_numpy(src), torch.from_numpy(tmpl), upsample_factor=usf,
        **kw)
    np.testing.assert_allclose(_np(got_s), _np(ref_s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(np.cos(_np(got_dp))),
                               float(np.cos(_np(ref_dp))), atol=1e-4)
    assert got_f.shape == shape and got_f.is_complex()
    if usf == 10:  # the planted shift, to the subpixel step
        np.testing.assert_allclose(_np(got_s)[:2], true[:2], atol=0.051)


def test_phase_cross_correlation_fourier_space(rng):
    tmpl = _template(rng, (16, 18))
    src = _shifted(tmpl, [[1.4, -2.2]])[0]
    sf, tf = np.fft.fftn(src), np.fft.fftn(tmpl)
    ref_s, _, _ = jF.phase_cross_correlation(
        jnp.asarray(sf, jnp.complex64), jnp.asarray(tf, jnp.complex64),
        upsample_factor=10, space="fourier", max_shifts=(4, 4))
    got_s, _, _ = tF.phase_cross_correlation(
        torch.from_numpy(sf.astype(np.complex64)),
        torch.from_numpy(tf.astype(np.complex64)), upsample_factor=10,
        space="fourier", max_shifts=(4, 4))
    np.testing.assert_allclose(_np(got_s), _np(ref_s), atol=1e-4)


def test_subpixel_refine_batched_matches_jax(rng):
    """The batched refinement (leading frame x patch dims, permuted
    layout) equals the JAX one per item."""
    shape = (12, 10, 4)
    prods = (rng.normal(size=(2, 3, 4, 12, 10))
             + 1j * rng.normal(size=(2, 3, 4, 12, 10))).astype(np.complex64)
    coarse = rng.integers(-3, 4, size=(2, 3, 3)).astype(np.float32)
    got_s, got_cc = tF.subpixel_refine(torch.from_numpy(prods),
                                       torch.from_numpy(coarse), 4, shape,
                                       prod_layout=(2, 0, 1))
    for b in range(2):
        for p in range(3):
            ref_s, ref_cc = jF.subpixel_refine(
                jnp.asarray(prods[b, p]), jnp.asarray(coarse[b, p]), 4,
                shape, prod_layout=(2, 0, 1))
            np.testing.assert_allclose(_np(got_s[b, p]), _np(ref_s),
                                       atol=1e-4)
            np.testing.assert_allclose(_np(got_cc[b, p]), _np(ref_cc),
                                       rtol=1e-4)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("border", [True, False, "min", "copy"])
def test_apply_shifts_fourier_matches_jax(rng, nd, border):
    shape = (16, 14) if nd == 2 else (12, 10, 6)
    img = rng.random(shape).astype(np.float32)
    shifts = np.array([1.6, -2.3, 0.7][:nd], np.float32)
    ref = jF.apply_shifts_fourier(jnp.asarray(img), jnp.asarray(shifts),
                                  0.3, border_nan=border)
    got = tF.apply_shifts_fourier(torch.from_numpy(img),
                                  torch.from_numpy(shifts), 0.3,
                                  border_nan=border)
    assert_rel(got, ref)
    # Batched: per-frame shifts over a leading dim.
    many = np.stack([shifts, -shifts])
    got_b = tF.apply_shifts_fourier(torch.from_numpy(np.stack([img, img])),
                                    torch.from_numpy(many), 0.0,
                                    border_nan=border)
    for i in range(2):
        assert_rel(got_b[i], jF.apply_shifts_fourier(
            jnp.asarray(img), jnp.asarray(many[i]), 0.0, border_nan=border))


def test_apply_shifts_fourier_from_spectrum(rng):
    img = rng.random((10, 12)).astype(np.float32)
    s = np.array([-1.2, 2.6], np.float32)
    half = np.fft.rfftn(img).astype(np.complex64)
    full = np.fft.fftn(img).astype(np.complex64)
    for spec, rshape in ((half, img.shape), (full, None)):
        ref = jF.apply_shifts_fourier(jnp.asarray(spec), jnp.asarray(s), 0.2,
                                      is_freq=True, border_nan=True,
                                      rfft_shape=rshape)
        got = tF.apply_shifts_fourier(torch.from_numpy(spec),
                                      torch.from_numpy(s), 0.2,
                                      is_freq=True, border_nan=True,
                                      rfft_shape=rshape)
        assert_rel(got, ref)


@pytest.mark.parametrize("border", ["min", True, "copy", "reflect", False])
@pytest.mark.parametrize("clamp", [True, False])
def test_apply_shifts_cubic_matches_jax(rng, border, clamp):
    for shape, shifts in (((14, 12), [2.4, -1.3]),
                          ((10, 8, 5), [-0.6, 1.8, 0.3])):
        img = rng.random(shape).astype(np.float32)
        s = np.asarray(shifts, np.float32)
        ref = jF.apply_shifts_cubic(jnp.asarray(img), jnp.asarray(s),
                                    border_nan=border, clamp_range=clamp)
        got = tF.apply_shifts_cubic(torch.from_numpy(img),
                                    torch.from_numpy(s), border_nan=border,
                                    clamp_range=clamp)
        assert_rel(got, ref)


@pytest.mark.parametrize("exclude_nans", [True, False])
def test_bin_median_matches_jax(rng, exclude_nans):
    video = rng.random((40, 6, 5)).astype(np.float32)
    video[3, 2, 2] = np.nan
    for t in (40, 37, 7):
        ref = jF.bin_median(jnp.asarray(video[:t]),
                            exclude_nans=exclude_nans)
        got = tF.bin_median(torch.from_numpy(video[:t]),
                            exclude_nans=exclude_nans)
        assert_rel(got, ref, 1e-6)


def test_nanmedian_even_count_matches_jnp(rng):
    """torch.nanmedian takes the lower middle value; the port averages
    the middle pair, as jnp.nanmedian (np.nanmedian) does."""
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert float(torch.nanmedian(torch.from_numpy(x))) == 2.0
    assert float(tF.nanmedian(torch.from_numpy(x))) == 2.5
    stack = rng.random((4, 5, 3)).astype(np.float32)
    stack[1, 0, 0] = stack[2, 1, 1] = stack[0, 1, 1] = np.nan
    stack[:, 4, 2] = np.nan
    for n in (4, 3, 2):
        ref = np.asarray(jnp.nanmedian(jnp.asarray(stack[:n]), axis=0))
        got = tF.nanmedian(torch.from_numpy(stack[:n]), dim=0)
        np.testing.assert_array_equal(np.isnan(_np(got)), np.isnan(ref))
        np.testing.assert_allclose(_np(got), ref, rtol=1e-7)


def test_registration_error_matches_jax():
    cc = np.complex64(3.0 + 4.0j)
    ref = jF.registration_error(jnp.asarray(cc), 30.0, 2.0)
    got = tF.registration_error(torch.tensor(cc), 30.0, 2.0)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# --------------------------------------------------------- kernel F
PM, PN, PZ, NP, PB = 16, 16, 4, 3, 2


def _pc_fixture(rng, z=PZ, np_=NP):
    """Patches = noise templates Fourier-shifted by known amounts."""
    tmpl = rng.random((np_, PM, PN, z)).astype(np.float32)
    true = np.stack([
        [[1.0, -2.0, 1.0], [-3.0, 0.0, -1.0], [2.0, 3.0, 0.0]],
        [[0.0, 1.0, -1.0], [2.0, -2.0, 1.0], [-1.0, -1.0, 0.0]],
    ])[:, :np_].astype(np.float32)
    if z == 1:
        true[..., 2] = 0.0
    pats = np.stack([_shifted(tmpl[p], true[:, p]) for p in range(np_)],
                    axis=1)
    return tmpl, pats, true


def _bounds(lb, ub, b=PB):
    row = np.zeros((b, 8), np.float32)
    row[:, :3] = lb
    row[:, 3:6] = ub
    return row


def _pc_both(tmpl, pats, bounds, z):
    tre, tim = jpp.patch_spectra(jnp.asarray(tmpl))
    ref = jpp.phase_corr_block(jpp.to_zm_n(jnp.asarray(pats)), tre, tim,
                               jnp.asarray(bounds), z=z, precision="highest",
                               interpret=True)
    t_re, t_im = phasecorr.patch_spectra(torch.from_numpy(tmpl))
    got = phasecorr.phase_corr_block_plain(
        phasecorr.to_zm_n(torch.from_numpy(pats)), t_re, t_im,
        torch.from_numpy(bounds), z=z)
    return got, ref


def test_phase_corr_block_plain_matches_pallas(rng):
    tmpl, pats, true = _pc_fixture(rng)
    bounds = _bounds([-4.0, -4.0, -2.0], [4.0, 4.0, 2.0])
    (g_s, g_re, g_im), (r_s, r_re, r_im) = _pc_both(tmpl, pats, bounds, PZ)
    np.testing.assert_array_equal(_np(g_s), _np(r_s))
    np.testing.assert_array_equal(_np(g_s), true)
    ref = _np(r_re) + 1j * _np(r_im)
    got = _np(g_re) + 1j * _np(g_im)
    assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))
    # The per-frame bounds differ: frame 1 excludes its true m shifts.
    bounds[1] = [0.0, -4.0, -2.0, 1.0, 4.0, 2.0, 0.0, 0.0]
    (g_s, _, _), (r_s, _, _) = _pc_both(tmpl, pats, bounds, PZ)
    np.testing.assert_array_equal(_np(g_s), _np(r_s))
    assert np.all(_np(g_s)[1, :, 0] == 0.0)


def test_phase_corr_block_empty_window(rng):
    """No candidate in the window: shift 0, as the masked -1 surface."""
    tmpl, pats, _ = _pc_fixture(rng)
    bounds = _bounds([-4.0, 2.0, -2.0], [4.0, 2.0, 2.0])  # n: [2, 1]
    (g_s, _, _), (r_s, _, _) = _pc_both(tmpl, pats, bounds, PZ)
    np.testing.assert_array_equal(_np(g_s), _np(r_s))
    assert not np.any(_np(g_s))
    cnt = phasecorr.window_counts(torch.from_numpy(bounds), (PM, PN, PZ))
    assert not cnt[:, 1].any() and cnt[:, 0].all() and cnt[:, 2].all()


def test_phase_corr_block_singleton_z(rng):
    tmpl, pats, true = _pc_fixture(rng, z=1, np_=2)
    bounds = _bounds([-4.0, -4.0, -1.0], [4.0, 4.0, 1.0])
    (g_s, _, _), (r_s, _, _) = _pc_both(tmpl, pats, bounds, 1)
    np.testing.assert_array_equal(_np(g_s), _np(r_s))
    np.testing.assert_array_equal(_np(g_s), true)


def test_window_tables_order():
    """Per-axis candidate counts of the window: the signed shifts in [lb,
    ub - 1] that the axis length has (a window wider than the axis keeps
    each wrapped index once)."""
    bounds = torch.from_numpy(np.concatenate([
        _bounds([-2.0, 0.0, -1.0], [3.0, 2.0, 1.0], b=1),
        _bounds([-9.0, 3.0, 2.0], [9.0, 2.0, 9.0], b=1)]))
    cnt = phasecorr.window_counts(bounds, (8, 7, 4))
    np.testing.assert_array_equal(cnt.numpy(), [[5, 2, 2], [8, 0, 1]])
    mask = tF._shift_window_mask((8, 7, 4), bounds[:, :3],
                                 bounds[:, 3:6])
    np.testing.assert_array_equal(
        mask.flatten(1).sum(1).numpy(), cnt.prod(dim=1).numpy())


# --------------------------------------------------------- kernel G
WSIZE, WGRID, WMAX, WDEV = (24, 20, 6), (3, 3, 2), (3, 3, 2), 2


@pytest.mark.parametrize("grid", [WGRID, (1, 1, 1), (3, 1, 2)])
def test_fused_warp_plain_matches_pallas_and_xla(rng, grid):
    """Including active field clipping (patch spread > max deviation)."""
    b = 3
    base = np.stack([rng.uniform(-ms, ms, b) for ms in WMAX],
                    axis=1).astype(np.float32)
    shifts = (base[:, None] + rng.uniform(
        -WDEV - 1.5, WDEV + 1.5, (b, int(np.prod(grid)), 3))).astype(
        np.float32)
    vol = rng.random((b,) + WSIZE, dtype=np.float32)
    ref_x = jax.vmap(lambda f, rs, ps: jmc._apply_remap_field(
        f, rs, ps, grid, "separable", WMAX, WDEV))(
        jnp.asarray(vol), jnp.asarray(base), jnp.asarray(shifts))
    ref_k = j_fused_warp(jnp.asarray(vol), jnp.asarray(shifts),
                         jnp.asarray(base), grid, WSIZE, WMAX, WDEV, tm=8,
                         tn=16, interpret=True)
    got = warp.fused_separable_warp(
        torch.from_numpy(vol), torch.from_numpy(shifts),
        torch.from_numpy(base), grid, WSIZE, WMAX, WDEV)
    for ref in (ref_x, ref_k):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)


def test_kernel_wrappers_take_plain_path_on_cpu(rng):
    tmpl, pats, _ = _pc_fixture(rng)
    t_re, t_im = phasecorr.patch_spectra(torch.from_numpy(tmpl))
    args = (phasecorr.to_zm_n(torch.from_numpy(pats)), t_re, t_im,
            torch.from_numpy(_bounds([-4.0] * 3, [4.0] * 3)))
    fused.reset_launch_counts()
    for a, b in zip(phasecorr.phase_corr_block(*args, z=PZ),
                    phasecorr.phase_corr_block_plain(*args, z=PZ)):
        assert torch.equal(a, b)
    vol = torch.rand((2,) + WSIZE)
    ps = torch.rand((2, 18, 3))
    rs = torch.zeros((2, 3))
    assert torch.equal(
        warp.fused_separable_warp(vol, ps, rs, WGRID, WSIZE, WMAX, WDEV),
        warp.fused_separable_warp_plain(vol, ps, rs, WGRID, WSIZE, WMAX,
                                        WDEV))
    counts = fused.launch_counts()
    assert counts["phase_corr_block"] == counts["fused_separable_warp"] == 0
    assert sum(counts.values()) == 0


# --------------------------------------------------------- resample
@pytest.mark.parametrize("use_base", [False, True])
def test_separable_warp_matches_jax(rng, use_base):
    size = (14, 12, 5)
    vol = rng.random(size, dtype=np.float32)
    shifts = rng.uniform(-2.5, 2.5, size + (3,)).astype(np.float32)
    bound = (2, 3, 1)
    kw_j, kw_t = {}, {}
    if use_base:
        base = np.array([1.7, -2.2, 0.4], np.float32)
        shifts = shifts + base
        kw_j = dict(base=jnp.asarray(base), base_bound=(3, 3, 2))
        kw_t = dict(base=torch.from_numpy(base), base_bound=(3, 3, 2))
    ref = jR.separable_warp(jnp.asarray(vol), jnp.asarray(shifts), bound,
                            **kw_j)
    got = tR.separable_warp(torch.from_numpy(vol), torch.from_numpy(shifts),
                            bound, **kw_t)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "edge"])
def test_trilinear_resample_matches_jax(rng, padding):
    size = (9, 8, 4)
    for vol in (rng.random(size, dtype=np.float32),
                rng.random(size + (3,), dtype=np.float32)):
        coords = rng.uniform(-1.5, 9.5, (200, 3)).astype(np.float32)
        ref = jR.trilinear_resample(jnp.asarray(vol), jnp.asarray(coords),
                                    padding=padding)
        got = tR.trilinear_resample(torch.from_numpy(vol),
                                    torch.from_numpy(coords),
                                    padding=padding)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)


def test_resample_footprints_and_inverse_warp_match_jax(rng):
    size = (10, 9, 4)
    p = size[0] * size[1] * size[2]
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in size],
                                indexing="ij"), -1).reshape(-1, 3)
    psi = (grid + rng.uniform(-1.2, 1.2, (p, 3))).astype(np.float32)
    fp = rng.random((p, 5), dtype=np.float32)
    np.testing.assert_allclose(
        _np(tR.resample_footprints(torch.from_numpy(fp),
                                   torch.from_numpy(psi), size)),
        _np(jR.resample_footprints(jnp.asarray(fp), jnp.asarray(psi),
                                   size)), rtol=0, atol=1e-5)
    vals = rng.random(p, dtype=np.float32)
    np.testing.assert_allclose(
        _np(tI.inverse_warp_nearest(torch.from_numpy(vals),
                                    torch.from_numpy(psi), size)),
        _np(jI.inverse_warp_nearest(jnp.asarray(vals), jnp.asarray(psi),
                                    size)), rtol=0, atol=1e-5)


# ----------------------------------------------------- MotionCorrect
def _both(video, template=None, **cfg):
    ref = jMC(video, jcfg.RegistrationConfig(**cfg)).motion_correct(
        template=None if template is None else jnp.asarray(template))
    got = tMC(video, tcfg.RegistrationConfig(**cfg),
              device="cpu").motion_correct(template=template)
    return got, ref


def _video(rng, shape, shifts, sigma=2.0):
    tmpl = _template(rng, shape, sigma)
    video = _shifted(tmpl, shifts)
    video += 0.01 * rng.normal(size=video.shape).astype(np.float32)
    return tmpl, video


RIGID_2D = [(0.0, 0.0), (2.3, -1.4), (-3.2, 2.1), (1.1, 3.3), (-2.4, -2.2),
            (3.1, 0.4)]
RIGID_3D = [(0.0, 0.0, 0.0), (2.3, -1.4, 0.3), (-1.7, 2.1, -0.6),
            (1.2, 0.8, 0.0)]


def _assert_rigid(got, ref):
    np.testing.assert_allclose(np.asarray(got.shifts_rig),
                               np.asarray(ref.shifts_rig), atol=1e-4)
    assert_rel(got.total_template_rig, ref.total_template_rig)
    assert_rel(got.mc[0], ref.mc[0])
    assert got.border_to_0 == ref.border_to_0


def test_motion_correct_rigid_2d_template_iteration(rng):
    """No template: bin-median init, two template iterations over two
    chunks (one registered in the refinement iteration)."""
    _, video = _video(rng, (32, 28), RIGID_2D)
    got, ref = _both(video, max_shifts=(5, 5), niter_rig=2, splits=3,
                     num_splits_to_process=2, frame_block=4)
    _assert_rigid(got, ref)
    for a, b in zip(got.templates_rig, ref.templates_rig):
        assert_rel(a, b)


def test_motion_correct_rigid_3d(rng):
    tmpl, video = _video(rng, (24, 20, 6), RIGID_3D)
    got, ref = _both(video, template=tmpl, max_shifts=(4, 4, 2),
                     border_nan="copy", frame_block=2)
    _assert_rigid(got, ref)
    np.testing.assert_allclose(np.asarray(got.shifts_rig),
                               -np.asarray(RIGID_3D), atol=0.25)


def test_rigid_correct_frames_cubic_apply(rng):
    tmpl, video = _video(rng, (24, 22), RIGID_2D[:3])
    ref = jmc.rigid_correct_frames(jnp.asarray(video), jnp.asarray(tmpl),
                                   (5, 5), apply_mode="cubic",
                                   add_to_movie=0.5)
    got = tmc.rigid_correct_frames(torch.from_numpy(video),
                                   torch.from_numpy(tmpl), (5, 5),
                                   apply_mode="cubic", add_to_movie=0.5)
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-4)
    assert_rel(got[0], ref[0])


PW = dict(pw_rigid=True, max_shifts=(3, 3, 1), strides=(16, 16, 4),
          overlaps=(8, 8, 0), max_deviation_rigid=2, border_nan=False,
          frame_block=5, dft_precision="highest")
PW_SHIFTS = [(0.0, 0.0, 0.0), (1.3, -0.6, 0.0), (-1.8, 1.2, 0.3),
             (0.7, 2.2, 0.0), (-0.4, -1.3, -0.3)]


def _pw_video(rng):
    """A smooth template and per-frame shifts that vary across patches
    (a rigid part plus a linear ramp in m)."""
    tmpl = _template(rng, (32, 32, 4))
    frames = []
    for i, s in enumerate(PW_SHIFTS):
        f = np.asarray(jF.apply_shifts_fourier(
            jnp.asarray(tmpl), jnp.asarray(s, jnp.float32),
            border_nan=False))
        ramp = 0.4 * (i % 2) * np.linspace(-1, 1, 32)[:, None, None]
        coords = np.stack(np.meshgrid(*[np.arange(d) for d in f.shape],
                                      indexing="ij"), -1).reshape(-1, 3)
        coords = coords + np.stack([np.broadcast_to(ramp, f.shape).ravel(),
                                    np.zeros(f.size), np.zeros(f.size)], -1)
        frames.append(np.asarray(jR.trilinear_resample(
            jnp.asarray(f), jnp.asarray(coords, jnp.float32),
            padding="edge")).reshape(f.shape))
    video = np.stack(frames).astype(np.float32)
    return tmpl, video + 0.01 * rng.normal(size=video.shape).astype(
        np.float32)


def _assert_pw(got, ref):
    for attr in ("x_shifts_els", "y_shifts_els", "z_shifts_els"):
        np.testing.assert_allclose(np.asarray(getattr(got, attr)),
                                   np.asarray(getattr(ref, attr)),
                                   atol=1e-4, err_msg=attr)
    assert_rel(got.total_template_els, ref.total_template_els)
    assert_rel(got.mc_els[0], ref.mc_els[0])
    assert got.border_to_0 == ref.border_to_0


@pytest.mark.parametrize("remap_mode,impl", [
    ("exact", "xla"), ("separable", "xla"), ("fused", "xla"),
    ("exact", "fused"), ("fused", "fused")])
def test_motion_correct_pwrigid_3d(rng, remap_mode, impl):
    tmpl, video = _pw_video(rng)
    got, ref = _both(video, template=tmpl, remap_mode=remap_mode,
                     phasecorr_impl=impl, **PW)
    _assert_pw(got, ref)


def test_pwrigid_block_estimates(rng):
    """The block entry's outputs for checking a run: both correlation
    paths report the same rigid estimate and integer patch shifts, the
    final shifts lie in the subpixel region around those, and a given
    rigid estimate (here in float64) stands in for the block's own."""
    tmpl, video = _pw_video(rng)
    frames, template = torch.from_numpy(video), torch.from_numpy(tmpl)
    cfg = {impl: tcfg.RegistrationConfig(**PW, phasecorr_impl=impl,
                                         remap_mode="separable")
           for impl in ("xla", "fused")}
    _, corr_x, est_x = tmc.pwrigid_block(frames, template, cfg["xla"], 0.5,
                                         estimates=True)
    _, corr_f, est_f = tmc.pwrigid_block(frames, template, cfg["fused"], 0.5,
                                         estimates=True)
    for key in ("rigid", "integer"):
        assert torch.equal(est_f[key], est_x[key]), key
    assert torch.equal(est_x["integer"], torch.round(est_x["integer"]))
    assert float((-corr_x - est_x["integer"]).abs().max()) <= 0.7 + 1e-5
    # The paths (and float64 below) sum the subpixel surface in another
    # order or precision: a near-tie may part them by one 0.1 px step.
    np.testing.assert_allclose(_np(corr_f), _np(corr_x), atol=0.1 + 1e-4)
    mov64, corr64, est64 = tmc.pwrigid_block(
        frames.double(), template.double(), cfg["xla"], 0.5,
        rigid_shifts=est_x["rigid"].double(), estimates=True)
    assert mov64.dtype == torch.float64
    assert torch.equal(est64["rigid"], est_x["rigid"].double())
    assert torch.equal(est64["integer"], est_x["integer"].double())
    np.testing.assert_allclose(_np(corr64), _np(corr_x), atol=0.1 + 1e-4)


def test_motion_correct_pwrigid_rigid_first_decimated(rng):
    """No template: the rigid phase seeds the pw-rigid one;
    ``rigid_decimate=4`` decimates the per-block rigid pre-estimate."""
    _, video = _video(rng, (48, 40), RIGID_2D)
    cfg = dict(pw_rigid=True, max_shifts=(5, 5), strides=(16, 16),
               overlaps=(8, 8), max_deviation_rigid=2, border_nan=False,
               frame_block=3, rigid_decimate=4, remap_mode="separable")
    got, ref = _both(video, **cfg)
    _assert_rigid(got, ref)
    _assert_pw(got, ref)


def test_motion_correct_pwrigid_dft_blend(rng):
    """The DFT path: upsampled patch grid, per-patch Fourier shifts, the
    shear guard and NaN-aware blending."""
    _, video = _video(rng, (40, 36), RIGID_2D[:4])
    cfg = dict(pw_rigid=True, max_shifts=(5, 5), strides=(16, 16),
               overlaps=(6, 6), max_deviation_rigid=2, use_remap=False,
               border_nan=True, frame_block=2, upsample_factor_grid=4)
    tmpl = np.asarray(jF.bin_median(jnp.asarray(video)))
    got, ref = _both(video, template=tmpl, **cfg)
    _assert_pw(got, ref)


def test_motion_correct_gsig_filt_2d(rng):
    """1p data: register high-passed frames, apply to the raw ones."""
    _, video = _video(rng, (36, 32), RIGID_2D[:4], sigma=3.0)
    got, ref = _both(video, max_shifts=(5, 5), gSig_filt=(3, 3),
                     border_nan=False, frame_block=4)
    _assert_rigid(got, ref)
    got, ref = _both(video, pw_rigid=True, max_shifts=(5, 5),
                     strides=(16, 16), overlaps=(8, 8),
                     max_deviation_rigid=2, gSig_filt=(3, 3),
                     border_nan=False, frame_block=4,
                     remap_mode="separable")
    _assert_pw(got, ref)
    img = video[0]
    assert_rel(tmc.high_pass_filter_space(torch.from_numpy(img), (3, 3)),
               jmc.high_pass_filter_space(jnp.asarray(img), (3, 3)))


def test_points_propagation_matches_jax(rng):
    tmpl, video = _pw_video(rng)
    got, ref = _both(video, template=tmpl, remap_mode="separable", **PW)
    pts = rng.uniform([2, 2, 0], [30, 30, 3], (12, 3))
    np.testing.assert_allclose(got.apply_shifts_points(pts),
                               ref.apply_shifts_points(pts), atol=1e-4)
    np.testing.assert_allclose(got.template_points_to_frame0(pts),
                               ref.template_points_to_frame0(pts),
                               atol=1e-4)
    np.testing.assert_allclose(got.apply_shifts_frame(pts, 2),
                               ref.apply_shifts_frame(pts, 2), atol=1e-4)
    rig_g, rig_r = _both(video, template=tmpl, max_shifts=(3, 3, 1))
    np.testing.assert_allclose(rig_g.template_points_to_frame0(pts),
                               rig_r.template_points_to_frame0(pts),
                               atol=1e-4)
    params = got.get_params()
    assert params["strides"] == (16, 16, 4) and params["is3D"]


def test_motion_correct_config_padding_matches_jax(rng):
    video = rng.random((3, 20, 18, 5)).astype(np.float32)
    cfg = dict(strides=(8, 8), overlaps=(4, 4), max_shifts=(3, 3))
    j = jMC(video, jcfg.RegistrationConfig(**cfg)).config
    t = tMC(video, tcfg.RegistrationConfig(**cfg), device="cpu").config
    assert (t.is3d, t.max_shifts, t.strides, t.overlaps) == (
        j.is3d, j.max_shifts, j.strides, j.overlaps)
    fields = {f.name for f in jcfg.RegistrationConfig.__dataclass_fields__
              .values()}
    assert fields == set(tcfg.RegistrationConfig.__dataclass_fields__)
    for f in fields:
        assert getattr(tcfg.RegistrationConfig(), f) == getattr(
            jcfg.RegistrationConfig(), f), f
