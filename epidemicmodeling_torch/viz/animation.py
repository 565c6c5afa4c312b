"""Animation writers for the spatial simulators.

The port's own copy of epidemicmodeling_tpu/viz/animation.py. The frames
may be tensors (copied to the host) or arrays; matplotlib is imported on
the first call, not with the module.

The reference renders its spatial sims to AVI videos
(testScripts/testCellularAutomataForPDESolutionWalking.m:65-101 writes the
diffusing field + walker markers each frame;
testPopulation2DMotionDynamics.m renders the agents over the obstacle map).
Here the equivalents are matplotlib animations written with whatever movie
writer the environment provides: ffmpeg for .mp4 when available, else the
always-available Pillow writer for .gif (the output path's extension is
rewritten accordingly and the actual path returned).
"""

from __future__ import annotations

import os

import numpy as np

from .plots import _host, _plt


def _make_writer(path: str, fps: int):
    """Pick a movie writer for ``path``; returns (writer, actual_path)."""
    from matplotlib import animation
    ext = os.path.splitext(path)[1].lower()
    if ext in (".mp4", ".avi", ".mov") and animation.writers.is_available(
            "ffmpeg"):
        return animation.FFMpegWriter(fps=fps), path
    actual = path if ext == ".gif" else os.path.splitext(path)[0] + ".gif"
    return animation.PillowWriter(fps=fps), actual


def animate_field(fields, path: str, fps: int = 20, points=None,
                  cmap: str = "viridis", every: int = 1,
                  title: str = "diffusion field"):
    """Render (T, Lx, Ly) field frames (optionally with (T, K, 2) marker
    positions overlaid, row/col index units) to a video/gif at ``path``.
    Returns the path actually written."""
    plt = _plt()
    fields = _host(fields)[::every]
    pts = None if points is None else _host(points)[::every]
    vmax = max(float(fields.max()), 1e-12)

    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(fields[0].T, origin="lower", cmap=cmap, vmin=0.0,
                   vmax=vmax)
    sc = None
    if pts is not None:
        sc = ax.scatter(pts[0, :, 0], pts[0, :, 1], c="red", s=30,
                        marker="o", edgecolors="white")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)

    writer, actual = _make_writer(path, fps)
    with writer.saving(fig, actual, dpi=80):
        for t in range(len(fields)):
            im.set_data(fields[t].T)
            if sc is not None:
                sc.set_offsets(pts[t])
            writer.grab_frame()
    plt.close(fig)
    return actual


def animate_agents(positions, path: str, obstacle_xy=None, fps: int = 20,
                   bounds=None, every: int = 1,
                   title: str = "population motion"):
    """Render (T, N, 2) agent positions (meters) over an obstacle map to a
    video/gif at ``path``. Returns the path actually written."""
    plt = _plt()
    pos = _host(positions)[::every]
    fig, ax = plt.subplots(figsize=(5, 5))
    if obstacle_xy is not None:
        ob = _host(obstacle_xy)
        ax.scatter(ob[:, 0], ob[:, 1], c="k", s=2, marker="s")
    sc = ax.scatter(pos[0, :, 0], pos[0, :, 1], c="tab:blue", s=12)
    if bounds is not None:
        ax.set_xlim(bounds[0], bounds[1])
        ax.set_ylim(bounds[2], bounds[3])
    ax.set_aspect("equal")
    ax.set_title(title)

    writer, actual = _make_writer(path, fps)
    with writer.saving(fig, actual, dpi=80):
        for t in range(len(pos)):
            sc.set_offsets(pos[t])
            writer.grab_frame()
    plt.close(fig)
    return actual
