"""Skeleton and attention drawing (port of agcn_tpu/utils/visualization.py).

Parity target: reference utils/visualization.py
(visualize_3dskeleton_in_matplotlib[_step]): 2D/3D matplotlib animation of
(N, C, T, V, M) sequences, and the live demo's G heatmaps. matplotlib is
imported inside the functions, so nothing else of the port needs it; a
saved figure is drawn with the non-interactive Agg backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from agcn_tpu_torch.graph import get_skeleton


def visualize_skeleton(data: np.ndarray,
                       skeleton_name: str = "ntu_rgb_d",
                       is_3d: bool = True,
                       sample: int = 0,
                       interval_ms: int = 50,
                       save_path: Optional[str] = None):
    """Animate one (N, C, T, V, M) sample's skeleton sequence.

    Returns the matplotlib FuncAnimation (the caller keeps a reference,
    or passes save_path to write a gif/mp4).
    """
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    edges = get_skeleton(skeleton_name).neighbor
    x = np.asarray(data[sample])  # (C, T, V, M)
    c, t, v, m = x.shape

    fig = plt.figure()
    ax = (fig.add_subplot(projection="3d") if is_3d and c >= 3
          else fig.add_subplot())
    lines = []
    for _ in range(m * len(edges)):
        (ln,) = ax.plot([], [], [], "o-", markersize=2) if is_3d \
            else ax.plot([], [], "o-", markersize=2)
        lines.append(ln)

    lim = np.abs(x).max() or 1.0
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    if is_3d:
        ax.set_zlim(-lim, lim)

    def update(frame):
        idx = 0
        for p in range(m):
            for (i, j) in edges:
                lines[idx].set_data([x[0, frame, i, p], x[0, frame, j, p]],
                                    [x[1, frame, i, p], x[1, frame, j, p]])
                if is_3d:
                    lines[idx].set_3d_properties(
                        [x[2, frame, i, p], x[2, frame, j, p]])
                idx += 1
        return lines

    anim = animation.FuncAnimation(fig, update, frames=t,
                                   interval=interval_ms, blit=False)
    if save_path:
        anim.save(save_path)
        plt.close(fig)
    return anim


def plot_attention(g: np.ndarray, save_path: Optional[str] = None,
                   title: str = "G"):
    """Heatmap of a (V, V) attention matrix (the reference demo's live
    G-matrix plot, infer/inference_220802.py:518-560). A stack of them,
    (K, V, V) subsets or (T, V, V) frames, is averaged over its first
    axis, as in the JAX package; an SGN recognizer's (B, T, V, V) over
    both leading axes (where JAX's imshow would refuse the 4-D array)."""
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = np.asarray(g)
    while g.ndim > 2:
        g = g.mean(axis=0)
    fig, ax = plt.subplots()
    im = ax.imshow(g, cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("destination joint")
    ax.set_ylabel("source joint")
    fig.colorbar(im)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig
