"""Registration's and seeding's block steps in the compiled-program layer
(:mod:`dnmf_tpu_torch.models.graphs`: ``rigid_block``, ``pwrigid_block``,
``summary_blocks``) on the CPU, where an entry keeps its step function
and calls it eagerly on its static buffers.

* The host probe of ``test_torch_port_graphs.py`` over each step after a
  warm-up call: no tensor made from host data, no host read.
* The cache's route against the step called directly, bit for bit: one
  entry per block shape (the tail block its own) replayed across
  template iterations, ``graphs.disabled()`` eager, and a one-rank mesh's
  registration through the same entries.
* ``MotionCorrect`` and ``summary_images`` through the cache against the
  JAX package at the tolerances of ``test_torch_port_registration.py``
  (shifts 1e-4 px, images 1e-4 of the reference's max magnitude) and
  ``test_torch_port_pipeline.py`` (summary images 1e-5); JAX runs Pallas
  in interpret mode, as its own tests do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dnmf_tpu import config as jcfg
from dnmf_tpu.data import streaming as jS
from dnmf_tpu.ops import fft_reg as jF
from dnmf_tpu.ops import seeding as jseed
from dnmf_tpu.registration import MotionCorrect as jMC
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data import streaming as tS
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import seeding as tseed
from dnmf_tpu_torch.registration import MotionCorrect as tMC
from dnmf_tpu_torch.registration import motion_correct as tmc
from test_torch_port_graphs import _HostProbe, close

SIZE3, SIZE2 = (32, 32, 4), (40, 36)
SEED_SIZE = (12, 10, 4)
PW = dict(max_shifts=(3, 3, 1), strides=(16, 16, 4), overlaps=(8, 8, 0),
          max_deviation_rigid=2, border_nan=False, dft_precision="highest")
PW2 = dict(max_shifts=(5, 5), strides=(16, 16), overlaps=(6, 6),
           max_deviation_rigid=2)
# (name, 2-D or 3-D, config): every block step the passes capture.
STEPS = {
    "rigid_2d": ("rigid", 2, dict(max_shifts=(5, 5), border_nan=True)),
    "rigid_3d": ("rigid", 3, dict(max_shifts=(3, 3, 1), border_nan="copy")),
    "rigid_gsig": ("rigid", 2, dict(max_shifts=(5, 5), gSig_filt=(3, 3),
                                    border_nan=False)),
    "pw_exact_xla": ("pw", 3, dict(PW, remap_mode="exact",
                                   phasecorr_impl="xla")),
    "pw_separable_xla": ("pw", 3, dict(PW, remap_mode="separable",
                                       phasecorr_impl="xla")),
    "pw_exact_fused": ("pw", 3, dict(PW, remap_mode="exact",
                                     phasecorr_impl="fused")),
    "pw_fused_fused": ("pw", 3, dict(PW, remap_mode="fused",
                                     phasecorr_impl="fused")),
    "pw_decimated": ("pw", 3, dict(PW, remap_mode="exact",
                                   phasecorr_impl="fused",
                                   rigid_decimate=4)),
    "pw_2d": ("pw", 2, dict(PW2, remap_mode="separable", border_nan=False)),
    "pw_dft_2d": ("pw", 2, dict(PW2, use_remap=False, border_nan=True)),
    "pw_dft_3d": ("pw", 3, dict(PW, use_remap=False, upsample_factor_grid=2)),
    "pw_gsig": ("pw", 2, dict(PW2, gSig_filt=(3, 3), remap_mode="separable",
                              border_nan=False)),
}


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


def _frames(rng, nd, b=3):
    """A smooth template and ``b`` frames of it, shifted and noisy."""
    shape = SIZE3 if nd == 3 else SIZE2
    tmpl = gaussian_filter(rng.normal(size=shape), 2.0).astype(np.float32)
    shifts = rng.uniform(-2, 2, (b, nd)) * ([1.0] * 2 + [0.3] * (nd - 2))
    frames = np.stack([np.asarray(jF.apply_shifts_fourier(
        jnp.asarray(tmpl), jnp.asarray(s, jnp.float32), border_nan=False))
        for s in shifts])
    frames += 0.01 * rng.normal(size=frames.shape)
    return torch.from_numpy(frames.astype(np.float32)), torch.from_numpy(tmpl)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = (t.contiguous().view(view[t.dtype]) for t in (a, b))
    return torch.equal(a, b)


def _call(step, frames, template, add=0.5, collect=True):
    kind, _, kw = STEPS[step]
    fn = graphs.rigid_block if kind == "rigid" else graphs.pwrigid_block
    return fn(frames, template, add, tcfg.RegistrationConfig(**kw), collect)


def _direct(step, frames, template, add=0.5):
    kind, _, kw = STEPS[step]
    fn = tmc.rigid_block if kind == "rigid" else tmc.pwrigid_block
    corrected, shifts = fn(frames, template, tcfg.RegistrationConfig(**kw),
                           add)
    return (corrected, shifts) + tmc.block_sums(corrected)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_registration_step_makes_no_host_tensor_and_reads_nothing(rng, step):
    frames, template = _frames(rng, STEPS[step][1])
    _call(step, frames, template)  # the warm-up: builds the constants
    with _HostProbe() as probe:
        _call(step, frames, template)
    assert probe.hits == [], probe.hits
    (entry,) = graphs.entries()
    assert entry.replays == 2


@pytest.mark.parametrize("step", sorted(STEPS))
def test_cached_registration_step_is_the_direct_call(rng, step):
    """Frames from the host, a new template at each call (a template
    iteration), one entry; ``collect=False`` hands out no movie."""
    frames, template = _frames(rng, STEPS[step][1])
    for i, collect in enumerate((True, False, True)):
        tmpl = template * (1.0 + 0.1 * i)
        got = _call(step, frames, tmpl, collect=collect)
        ref = _direct(step, frames, tmpl)
        assert (got[0] is None) == (not collect)
        for a, b in zip(got, ref):
            if a is not None:
                assert same_bits(a, b)
    (entry,) = graphs.entries()
    assert entry.replays == 3 and entry.name == STEPS[step][0] + (
        "rigid_block" if STEPS[step][0] == "pw" else "_block")


def _seed_blocks(rng, shifted, b=8, t=21):
    """``(carry, blocks)``: the pass's empty moments and its padded
    blocks ``(frames, valid, shifts or None)``, the last one short."""
    p = int(np.prod(SEED_SIZE))
    video = torch.from_numpy(rng.normal(1.0, 1.0, (t, p)).astype(np.float32))
    sh = torch.from_numpy(np.pad(rng.uniform(-2, 2, (t, 3)), ((0, b), (0, 0)))
                          .astype(np.float32))
    blocks = []
    for s in range(0, t, b):
        blk = video[s:s + b]
        valid = torch.tensor(blk.shape[0])
        blk = torch.nn.functional.pad(blk, (0, 0, 0, b - blk.shape[0]))
        blocks.append((blk, valid, sh[s:s + b] if shifted else None))
    zeros = torch.zeros(p)
    carry = (zeros, zeros, zeros, torch.zeros((3, p)), zeros,
             torch.full((p,), -torch.inf), zeros, torch.tensor(0))
    return carry, blocks


@pytest.mark.parametrize("shifted", [False, True])
def test_summary_step_makes_no_host_tensor_and_reads_nothing(rng, shifted):
    carry, blocks = _seed_blocks(rng, shifted)
    graphs.summary_blocks(carry, blocks[:1], SEED_SIZE, clamp=True)
    with _HostProbe() as probe:
        graphs.summary_blocks(carry, blocks, SEED_SIZE, clamp=True)
    assert probe.hits == [], probe.hits


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_cached_summary_blocks_are_the_direct_folds(rng, shifted, clamp):
    """Every block of a pass through one entry (the short tail padded to
    the block's shape), the carry kept in its buffers, bit for bit the
    folds called directly; a second pass starts from its own carry."""
    carry, blocks = _seed_blocks(rng, shifted)
    ref = carry
    for frames, valid, sh in blocks:
        ref = tseed.fold_block(ref, frames, valid, sh, SEED_SIZE, clamp)
    for _ in range(2):
        got = graphs.summary_blocks(carry, iter(blocks), SEED_SIZE, clamp)
        assert all(same_bits(a, b) for a, b in zip(got, ref))
    (entry,) = graphs.entries()
    assert entry.name == "summary_block"
    assert entry.replays == 2 * len(blocks)
    # What a pass hands out is no buffer of the entry.
    kept = {t.untyped_storage().data_ptr() for t in entry.inputs}
    assert not kept & {t.untyped_storage().data_ptr() for t in got}


def _video(rng, nd, t):
    frames, tmpl = _frames(rng, nd, t)
    return frames.numpy() + 2.0, tmpl.numpy() + 2.0


@pytest.mark.parametrize("pw_rigid", [False, True])
def test_motion_correct_replays_one_entry_per_block_shape(rng, pw_rigid):
    """T=7 in blocks of 3: a 3-frame entry and a 1-frame tail entry per
    pass, replayed in each of two template iterations; eager under
    ``graphs.disabled()``, with the same bits."""
    video, _ = _video(rng, 3, 7)
    cfg = tcfg.RegistrationConfig(
        **PW, pw_rigid=pw_rigid, remap_mode="fused", phasecorr_impl="fused",
        frame_block=3, niter_rig=2, niter_els=2, splits_rig=1, splits_els=1,
        return_mc=True)
    got = tMC(video, cfg, device="cpu").motion_correct()
    replays = {(e.name, e.inputs[0].shape[0]): e.replays
               for e in graphs.entries()}
    want = {("rigid_block", 3): 4, ("rigid_block", 1): 2}
    if pw_rigid:
        want.update({("pwrigid_block", 3): 4, ("pwrigid_block", 1): 2})
    assert replays == want
    graphs.clear()
    with graphs.disabled():
        ref = tMC(video, cfg, device="cpu").motion_correct()
    assert graphs.entries() == []
    names = ["shifts_rig", "mc", "templates_rig"] + (
        ["x_shifts_els", "y_shifts_els", "z_shifts_els", "mc_els",
         "templates_els"] if pw_rigid else [])
    for name in names:
        for a, b in zip(getattr(got, name), getattr(ref, name)):
            assert np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True), name
    tot = "total_template_els" if pw_rigid else "total_template_rig"
    assert same_bits(getattr(got, tot), getattr(ref, tot))


def test_tile_and_correct_is_a_block_of_one(rng):
    frames, template = _frames(rng, 2, 1)
    kw = {k: v for k, v in PW2.items()}
    got = tmc.tile_and_correct(frames[0], template, kw.pop("strides"),
                               kw.pop("overlaps"), kw.pop("max_shifts"),
                               remap_mode="separable", add_to_movie=0.5,
                               border_nan=False, **kw)
    (entry,) = graphs.entries()
    assert entry.name == "pwrigid_block" and entry.inputs[0].shape[0] == 1
    ref = _direct("pw_2d", frames, template)
    assert same_bits(got[0], ref[0][0]) and same_bits(got[1], ref[1][0])


def test_one_rank_mesh_registration_stays_eager(rng, tmp_path):
    """On a one-rank ``gloo`` mesh the sharded registration's frame blocks
    go through the registration entries (T=4 in blocks of 3: a 3-frame
    and a 1-frame entry per pass), bit for bit the ``graphs.disabled()``
    run, which makes none, and the single-process passes."""
    import contextlib

    import torch.distributed as dist

    from dnmf_tpu_torch.parallel import (make_mesh, sharded_register_pwrigid,
                                         sharded_register_rigid)

    video, tmpl = _video(rng, 3, 4)
    cfg = tcfg.RegistrationConfig(**PW, pw_rigid=True, frame_block=3,
                                  remap_mode="separable")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    runs = []
    try:
        mesh = make_mesh(num_time=1)
        for cached in (True, False):
            graphs.clear()
            with contextlib.nullcontext() if cached else graphs.disabled():
                rig = sharded_register_rigid(video, cfg, mesh, template=tmpl,
                                             device="cpu")
                pw = sharded_register_pwrigid(video, cfg, mesh,
                                              template=tmpl, device="cpu")
            runs.append((rig, pw, sorted(
                (e.name, e.inputs[0].shape[0]) for e in graphs.entries())))
    finally:
        dist.destroy_process_group()
    (rig, pw, entries), (rig_e, pw_e, none) = runs
    assert none == []
    assert entries == [("pwrigid_block", 1), ("pwrigid_block", 3),
                       ("rigid_block", 1), ("rigid_block", 3)]
    for got, ref in ((rig, rig_e), (pw, pw_e)):
        assert same_bits(got[0], ref[0])
        assert np.array_equal(got[1], ref[1])
        assert np.array_equal(got[2], ref[2])
    # The single-process passes (through the cache) give the same bits.
    template = torch.from_numpy(tmpl)
    for run, fn in ((rig, tmc._batch_rigid), (pw, tmc._batch_pwrigid)):
        single = fn(video, cfg, "cpu", template)
        assert same_bits(run[0], single[0])
        assert np.array_equal(run[1], single[-1])


def _assert_motion(got, ref, pw_rigid):
    attrs = (("x_shifts_els", "y_shifts_els", "z_shifts_els") if pw_rigid
             else ("shifts_rig",))
    for attr in attrs:
        np.testing.assert_allclose(np.asarray(getattr(got, attr)),
                                   np.asarray(getattr(ref, attr)), atol=1e-4,
                                   err_msg=attr)
    tot, movie = (("total_template_els", "mc_els") if pw_rigid
                  else ("total_template_rig", "mc"))
    for a, b in ((getattr(got, tot), getattr(ref, tot)),
                 (getattr(got, movie)[0], getattr(ref, movie)[0])):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        scale = max(float(np.nanmax(np.abs(b))), 1e-30)
        assert float(np.nanmax(np.abs(a - b))) <= 1e-4 * scale


@pytest.mark.parametrize("case", ["rigid_2d", "pw_fused_fused"])
def test_motion_correct_through_the_cache_matches_jax(rng, case):
    kind, nd, kw = STEPS[case]
    video, tmpl = _video(rng, nd, 5)
    cfg = dict(kw, pw_rigid=kind == "pw", frame_block=2, return_mc=True)
    ref = jMC(video, jcfg.RegistrationConfig(**cfg)).motion_correct(
        template=jnp.asarray(tmpl))
    got = tMC(video, tcfg.RegistrationConfig(**cfg),
              device="cpu").motion_correct(template=tmpl)
    assert {e.name for e in graphs.entries()} == (
        {"pwrigid_block"} if kind == "pw" else {"rigid_block"})
    _assert_motion(got, ref, kind == "pw")


def _seed_video(rng, t=20):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SEED_SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    pos = rng.uniform([2, 2, 1], [10, 8, 3], (4, 3))
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 4.0)
    c = rng.exponential(1.0, (4, t)) * (rng.uniform(size=(4, t)) < 0.4)
    video = (a @ c).T + 0.05 * rng.uniform(size=(t, grid.shape[0]))
    return video.reshape((t,) + SEED_SIZE).astype(np.float32)


@pytest.mark.parametrize("shifted", [False, True])
def test_summary_images_streamed_equal_array_over_two_partitions(rng,
                                                                 shifted):
    video = _seed_video(rng)
    shifts = rng.uniform(-1.5, 1.5, (video.shape[0], 3)) if shifted else None
    ref = tseed.summary_images(video, SEED_SIZE, frame_block=8,
                               shifts=shifts, device="cpu")
    for block in (4, 7):
        got = tseed.summary_images(
            tS.StreamingVideo(video, block=block, device="cpu"), SEED_SIZE,
            shifts=shifts)
        for g, r in zip(got, ref):
            close(g, r, 1e-5)
    # Three passes, one entry each: the block shapes 8, 4 and 7.
    assert sorted(e.replays for e in graphs.entries()) == [3, 3, 5]


@pytest.mark.parametrize("shifted", [False, True])
def test_summary_images_through_the_cache_match_jax(rng, shifted):
    video = _seed_video(rng)
    shifts = rng.uniform(-1.5, 1.5, (video.shape[0], 3)) if shifted else None
    ref = jseed.summary_images(jS.StreamingVideo(video, block=7), SEED_SIZE,
                               shifts=shifts)
    got = tseed.summary_images(
        tS.StreamingVideo(video, block=7, device="cpu"), SEED_SIZE,
        shifts=shifts)
    (entry,) = graphs.entries()
    assert entry.name == "summary_block" and entry.replays == 3
    for g, r in zip(got, ref):
        close(g, r, 1e-5)
    with graphs.disabled():
        eager = tseed.summary_images(
            tS.StreamingVideo(video, block=7, device="cpu"), SEED_SIZE,
            shifts=shifts)
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g, e)
