"""Host-side visualization (matplotlib): trace stacks, footprint maps,
trajectory paths, animated max-projection videos.

The port's own copy of ``dnmf_tpu/viz.py`` (NumPy and matplotlib only):
stacked offset trace plots, HSV-colored footprint maps, ground-truth vs
estimate trajectory paths, animated max projections with tracked
centers.  matplotlib is imported inside each function, so importing this
module needs none; pass tensors as NumPy arrays (``.cpu().numpy()``).
"""

from __future__ import annotations

import numpy as np


def _hsv_colors(n: int):
    import matplotlib.pyplot as plt

    return plt.cm.hsv(np.linspace(0, 1, n + 1)[:-1])[:, :3]


def _finish(fig, save, file):
    import matplotlib.pyplot as plt

    if save:
        fig.savefig(file + ".png", format="png", dpi=120)
        fig.savefig(file + ".pdf", format="pdf")
        plt.close("all")
    else:
        plt.show()


def visualize_image(img, save=False, file=None):
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.imshow(np.asarray(img))
    _finish(fig, save, file)


def visualize_images(ims, titles, save=False, file=None):
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 5))
    for i, im in enumerate(ims):
        plt.subplot(1, len(ims), i + 1)
        plt.imshow(np.asarray(im))
        plt.title(titles[i])
    _finish(fig, save, file)


def visualize_temporal(x, titlestr="", fontsize=12, linewidth=2,
                       save=False, file=None):
    """Stacked offset trace plot (reference ``visualize_temporal``)."""
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    fig = plt.figure(figsize=(5, max(2, x.shape[0])))
    colors = _hsv_colors(len(x))
    offset = np.append(
        0.0, np.nanmax(x[:-1, :], 1) - np.nanmin(x[:-1, :], 1)
    )
    s = x - np.nanmin(x, 1)[:, None] + np.cumsum(offset)[:, None]
    for i in range(len(s)):
        plt.plot(s[i], linewidth=linewidth, color=colors[i])
    plt.yticks(s[:, 0], [str(i) for i in range(s.shape[0])])
    plt.title(titlestr)
    _finish(fig, save, file)


def visualize_spatial(a, save=False, file=None, rgb=True):
    """HSV-colored footprint map (reference ``visualize_spatial``).

    Args:
      a: ``[M, N, K]`` max-projected footprints.
    """
    import matplotlib.pyplot as plt

    a = np.asarray(a)
    colors = _hsv_colors(a.shape[2])
    if rgb:
        fig = plt.figure(figsize=(5, 5))
        colored = np.einsum("mnk,ks->mns", a, colors)
        plt.imshow(np.clip(2 * colored / (colored.max() + 1e-32), 0, 1))
    else:
        m = int(np.sqrt(a.shape[2]))
        n = int(np.ceil(a.shape[2] / m))
        fig = plt.figure(figsize=(3 * n, 3 * m))
        for i in range(a.shape[2]):
            plt.subplot(m, n, i + 1)
            colored = np.einsum(
                "mnk,ks->mns", a[:, :, i][:, :, None],
                colors[i][None, :],
            )
            plt.imshow(np.clip(2 * colored / (colored.max() + 1e-32), 0, 1))
            plt.axis("off")
    _finish(fig, save, file)


def visualize_trajectory(p1, p2, save=False, file=None, flip_axis=True):
    """Ground-truth vs estimated position paths (reference
    ``visualize_trajectory``).

    Args:
      p1, p2: ``[K, 3, T]`` position tracks (solid / dashed).
    """
    import matplotlib.pyplot as plt

    p1, p2 = np.asarray(p1), np.asarray(p2)
    fig = plt.figure(figsize=(10, 10))
    colors = _hsv_colors(p1.shape[0])
    i, j = (1, 0) if flip_axis else (0, 1)
    for k in range(p1.shape[0]):
        c = colors[k]
        plt.scatter(p1[k, i, 0], p1[k, j, 0], color=c)
        plt.plot(p1[k, i, :], p1[k, j, :], color=c)
        plt.scatter(p2[k, i, 0], p2[k, j, 0], color=c, marker="x")
        plt.plot(p2[k, i, :], p2[k, j, :], color=c, linestyle="--")
    plt.grid()
    if flip_axis:
        plt.gca().invert_yaxis()
    _finish(fig, save, file)


def visualize_video(video=None, tracks=None, u_colors=True, labels=None,
                    scale=1.0, fontsize=20, fps=10, save=False,
                    file=None):
    """Animated max-projection with tracked centers (reference
    ``visualize_video``).

    Args:
      video: ``[M, N, Z, T]``; tracks: ``[K, 3, T]``.
      u_colors: per-track HSV colors (as the reference's); ``False``
        draws every center marker (and label) black.
    """
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    if video is not None:
        video = np.asarray(video)
        num_frames = video.shape[3]
    elif tracks is not None:
        tracks = np.asarray(tracks)
        num_frames = tracks.shape[2]
    else:
        raise ValueError("need video or tracks")
    if tracks is not None:
        tracks = np.asarray(tracks)
        colors = (_hsv_colors(tracks.shape[0]) if u_colors
                  else np.zeros((tracks.shape[0], 3)))

    fig, ax = plt.subplots(figsize=(10, 10))
    artists = []
    im = sc = None
    if video is not None:
        im = ax.imshow(video[:, :, :, 0].max(2).squeeze())
        artists.append(im)
    if tracks is not None:
        sc = ax.scatter(tracks[:, 1, 0], tracks[:, 0, 0], marker="x",
                        color=colors)
        ax.set_aspect("equal", adjustable="box")
        artists.append(sc)
    time_text = fig.text(0.5, 0.03, "Frame = 0",
                         horizontalalignment="center",
                         verticalalignment="top", fontsize=fontsize)
    ax.axis("off")
    try:
        from matplotlib_scalebar.scalebar import ScaleBar

        ax.add_artist(ScaleBar(scale, "um"))
    except ImportError:
        pass
    annots = []
    if labels is not None and tracks is not None:
        for i, txt in enumerate(labels):
            annots.append(
                ax.text(tracks[i, 1, 0], tracks[i, 0, 0], txt,
                        color=colors[i], fontsize=8)
            )

    def animate(t):
        if video is not None:
            im.set_data(video[:, :, :, t].max(2).squeeze())
        if tracks is not None:
            sc.set_offsets(tracks[:, [1, 0], t])
            for i, an in enumerate(annots):
                an.set_x(tracks[i, 1, t])
                an.set_y(tracks[i, 0, t])
        time_text.set_text(f"Frame = {t}")
        # blit only redraws returned artists — include the text overlays.
        return tuple(artists) + tuple(annots) + (time_text,)

    anim = animation.FuncAnimation(fig, animate, frames=num_frames,
                                   interval=500, blit=True)
    if save:
        try:
            writer = animation.writers["ffmpeg"](
                fps=fps, metadata={}, bitrate=1800
            )
        except (KeyError, RuntimeError):
            writer = animation.PillowWriter(fps=fps)
            if not file.endswith(".gif"):
                file = file.rsplit(".", 1)[0] + ".gif"
        anim.save(file, writer=writer)
        plt.close("all")
    else:
        plt.show()
