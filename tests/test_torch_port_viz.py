"""The port's copy of the visualization module renders and saves every
figure as ``tests/test_viz.py`` holds the JAX package's, and imports no
matplotlib until a figure is drawn."""

import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dnmf_tpu_torch import viz  # noqa: E402


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)


def test_visualize_temporal(tmp_path, rng_np):
    x = rng_np.random((4, 30))
    viz.visualize_temporal(x, titlestr="traces", save=True,
                           file=str(tmp_path / "temporal"))
    assert (tmp_path / "temporal.png").exists()
    assert (tmp_path / "temporal.pdf").exists()


def test_visualize_spatial(tmp_path, rng_np):
    a = rng_np.random((16, 16, 3))
    viz.visualize_spatial(a, save=True, file=str(tmp_path / "spatial"))
    assert (tmp_path / "spatial.png").exists()
    viz.visualize_spatial(a, save=True, rgb=False,
                          file=str(tmp_path / "spatial_grid"))
    assert (tmp_path / "spatial_grid.png").exists()


def test_visualize_trajectory(tmp_path, rng_np):
    p = rng_np.random((3, 3, 10)) * 20
    viz.visualize_trajectory(p, p + 0.5, save=True,
                             file=str(tmp_path / "traj"))
    assert (tmp_path / "traj.png").exists()


def test_visualize_images(tmp_path, rng_np):
    ims = [rng_np.random((8, 8)) for _ in range(2)]
    viz.visualize_images(ims, ["a", "b"], save=True,
                         file=str(tmp_path / "ims"))
    assert (tmp_path / "ims.png").exists()
    viz.visualize_image(ims[0], save=True, file=str(tmp_path / "im"))
    assert (tmp_path / "im.png").exists()


def test_visualize_video_gif(tmp_path, rng_np):
    video = rng_np.random((10, 10, 2, 4))
    tracks = rng_np.random((2, 3, 4)) * 10
    viz.visualize_video(video=video, tracks=tracks, labels=["a", "b"],
                        save=True, file=str(tmp_path / "vid.mp4"))
    # ffmpeg may be absent: falls back to GIF.
    assert (tmp_path / "vid.mp4").exists() or (
        tmp_path / "vid.gif"
    ).exists()


def test_import_needs_no_matplotlib():
    """The card's machine has no matplotlib: importing the module must
    not import it."""
    code = ("import sys; import dnmf_tpu_torch.viz; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "False"
