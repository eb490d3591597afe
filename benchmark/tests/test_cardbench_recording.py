"""The recordings: a configuration without neuron motion draws exactly
what it drew before the motion existed, and one with it moves each cell
off its anchor by a draw of its own generator; a stored configuration's
file (in memory) holds the resident draw's bytes and is freed after the
run, and a resident one makes none."""

import hashlib

import numpy as np
import pytest
import torch

from cardbench import harness, recording, spec
from conftest import held_config, stored_files, tiny_cell

# sha256 of the tensors' bytes, made on the CPU (PyTorch 2.13) by the
# recording code before neuron motion was added, at these shapes and the
# seed 2**31 + 17.
SHAPES = {"whole_brain_k200": ([48, 44, 6], 6, 8),
          "roi_k50": ([28, 24, 4], 5, 6)}
CHECKSUMS = {
    "whole_brain_k200": {
        "video": "7f601b4de5b469743513d860000e13370f06a5f34738df2589522108fcb7a51b",
        "pos": "c255aac6ed67ea990c4a889b5c7fbe03d9be0e68a76c74404502cca075db1d3f",
        "beta0": "010c1bf170815ae4df59ab4c57b4134ba66687782c8bf010ed208cc70515a24e"},
    "roi_k50": {
        "video": "840dd6077e1abc5fe873e535f39467228da482a2ca3f3ce6a23386e8f3217fed",
        "pos": "c4fff1c24e9deca27e02225d4fc99ab06b64670f8def67e432f6adc205e89fc1",
        "beta0": "b233b5498a823213493e3a8d4341f8595cd986110aedef833a3f25a8c45ba91b"},
}
SEED = (1 << 31) + 17


def _config(name, shape=None):
    if name == "whole_brain_k200_raw":  # no cell runs it yet
        cfg = held_config(name)
    else:
        cfg = spec.cell({"whole_brain_k200": "wb_demix",
                         "roi_k50": "roi_demix",
                         "whole_brain_k200_gp": "wb_refine"}[name]
                        )["config_spec"]
    size, k, t = shape or SHAPES[name]
    cfg.update(size=size, num_neurons=k, num_frames=t)
    return cfg


def _sha(x):
    return hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_without_neuron_motion_the_tensors_are_bit_identical(name):
    rec = recording.make(_config(name), SEED, torch.device("cpu"))
    assert "neuron_motion" not in _config(name)["assumed"]
    assert {k: _sha(getattr(rec, k)) for k in CHECKSUMS[name]} == \
        CHECKSUMS[name]


def test_neuron_motion_moves_the_cells_and_nothing_else():
    cfg = _config("whole_brain_k200_gp", SHAPES["whole_brain_k200"])
    still = recording.make(_config("whole_brain_k200"), SEED,
                           torch.device("cpu"))
    moving = recording.make(cfg, SEED, torch.device("cpu"))
    torch.testing.assert_close(moving.pos, still.pos, rtol=0, atol=0)
    torch.testing.assert_close(moving.beta0, still.beta0, rtol=0, atol=0)
    assert not torch.equal(moving.video, still.video)


def test_gp_offsets_have_the_rbf_covariance():
    """Over many frames the offsets' covariance across neurons along each
    axis is ``a_d exp(-(x_i - x_j)^2 / (2 ls^2))`` of the anchors."""
    gen = torch.Generator().manual_seed(5)
    pos = torch.rand((8, 3), generator=gen) * torch.tensor([40.0, 40.0,
                                                            4.0])
    motion = {"model": "gp", "amplitude_px2": [5.0, 2.0, 0.01],
              "length_scale_px": 10.0}
    off = recording._gp_offsets(gen, pos, 20000, motion)
    assert off.shape == (20000, 8, 3)
    for d, amp in enumerate(motion["amplitude_px2"]):
        x = pos[:, d].double()
        want = amp * torch.exp(-0.5 * ((x[:, None] - x[None, :]) / 10.0)
                               ** 2)
        got = torch.cov(off[:, :, d].double().T)
        # 20,000 draws: a sample covariance's standard error is ~1% of
        # a_d; 5% allowed
        assert float((got - want).abs().max()) < 0.05 * amp
    with pytest.raises(ValueError):
        recording._gp_offsets(gen, pos, 2, {**motion, "model": "walk"})


def test_a_stored_recording_reads_back_bit_equal_to_the_resident_draw(
        scratch):
    cfg = _config("whole_brain_k200_raw", SHAPES["whole_brain_k200"])
    cfg["storage"]["block"] = 4  # 8 frames: two blocks
    rec = recording.make(cfg, SEED, torch.device("cpu"))
    resident = recording.make(_config("whole_brain_k200"), SEED,
                              torch.device("cpu"))
    video = rec.video.clone()
    torch.testing.assert_close(video, resident.video, rtol=0, atol=0)
    stored = recording.store(rec, cfg["storage"])
    assert stored.shape == tuple(video.shape)
    in_file = np.fromfile(stored.path, dtype=np.float32)
    assert in_file.tobytes() == video.numpy().tobytes()
    idx = torch.tensor([6, 0, 3])
    flat = video.reshape(video.shape[0], -1)
    assert torch.equal(stored.rows(idx), flat[idx])
    assert torch.equal(stored.frames(2, 7), flat[2:7])
    assert torch.equal(stored.pos, rec.pos)
    assert torch.equal(stored.beta0, rec.beta0)
    assert stored_files() and not list(scratch.iterdir())
    stored.close()
    assert not stored_files()
    with pytest.raises(ValueError):
        recording.store(rec, {**cfg["storage"], "kind": "tiff"})


def test_a_resident_configuration_hands_frames_flat_and_writes_no_file(
        scratch):
    cell = tiny_cell("wb_round")
    with harness.fit_source(cell, SEED, torch.device("cpu")) as (rec,
                                                                  source):
        assert source is rec
        assert source.frames_flat().shape == (6, 24 * 20 * 6)
        assert not list(scratch.iterdir())
    made = recording.make(cell["config_spec"], SEED, torch.device("cpu"))
    assert torch.equal(rec.video, made.video)


def test_a_stored_configuration_streams_its_file_and_removes_it(scratch):
    from dnmf_tpu_torch.data import streaming

    cell = tiny_cell("wb_stream_raw")
    made = recording.make(cell["config_spec"], SEED, torch.device("cpu"))
    with harness.fit_source(cell, SEED, torch.device("cpu")) as (rec,
                                                                  source):
        assert not hasattr(source, "frames_flat")
        assert isinstance(source, (streaming.RawFileVideo,
                                   streaming.StreamingVideo))
        assert (source.num_frames, source.block) == (6, 4)
        assert stored_files()
        got = torch.cat([f[:n] for f, _, n in source.blocks()])
        assert torch.equal(got, made.frames_flat())
        assert torch.equal(rec.rows(torch.arange(6)), made.frames_flat())
    assert not stored_files() and not list(scratch.iterdir())
