"""Rollout animations as GIFs.

Counterpart of ``hyper_graph_nets_tpu/utils/viz.py``: flag's 3-D trisurf
cloth, plate's two-panel 3-D scatter with the obstacle in its own colour,
and cylinder's 2-D speed field (tripcolor), each prediction beside ground
truth, written with PillowWriter.  matplotlib is imported inside the
functions, so the port imports and runs without it: :func:`animate_rollout`
then writes no GIF, logs why and returns None, as the JAX package's does on
any failure.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    return plt, animation


def _quad_to_tris(faces: np.ndarray) -> np.ndarray:
    if faces.shape[-1] == 3:
        return faces
    return np.concatenate([faces[:, [0, 1, 2]], faces[:, [2, 3, 0]]], axis=0)


def _save(fig, plt, animation, draw, frames: int, path: str) -> str:
    try:
        anim = animation.FuncAnimation(fig, draw, frames=frames, interval=100)
        anim.save(path, writer=animation.PillowWriter(fps=10))
    finally:
        plt.close(fig)
    return path


def animate_flag(traj_ops: Dict[str, np.ndarray], path: str, stride: int = 1) -> str:
    """3-D cloth animation: prediction (left) against ground truth (right)."""
    plt, animation = _pyplot()
    pred = np.asarray(traj_ops["pred_pos"])[::stride]
    gt = np.asarray(traj_ops["gt_pos"])[: len(pred) * stride : stride]
    faces = _quad_to_tris(np.asarray(traj_ops["faces"])[0])
    fig = plt.figure(figsize=(10, 5))
    ax1 = fig.add_subplot(121, projection="3d")
    ax2 = fig.add_subplot(122, projection="3d")
    lims = np.stack([gt.min(axis=(0, 1)), gt.max(axis=(0, 1))])

    def draw(i):
        for ax, data, title in ((ax1, pred, "prediction"), (ax2, gt, "ground truth")):
            ax.clear()
            ax.set_title(f"{title} t={i * stride}")
            ax.plot_trisurf(data[i][:, 0], data[i][:, 1], data[i][:, 2], triangles=faces, alpha=0.8)
            ax.set_xlim(lims[0, 0], lims[1, 0])
            ax.set_ylim(lims[0, 1], lims[1, 1])
            ax.set_zlim(lims[0, 2], lims[1, 2])
        return []

    return _save(fig, plt, animation, draw, len(pred), path)


def animate_plate(traj_ops: Dict[str, np.ndarray], path: str, stride: int = 1) -> str:
    """Two-panel 3-D scatter: the plate in blue, the obstacle (``mask``) in
    red; prediction (left) against ground truth (right)."""
    plt, animation = _pyplot()
    pred = np.asarray(traj_ops["pred_pos"])[::stride]
    gt = np.asarray(traj_ops["gt_pos"])[: len(pred) * stride : stride]
    mask = traj_ops.get("mask")
    obstacle = np.asarray(mask, bool) if mask is not None else np.zeros(pred.shape[1], bool)
    fig = plt.figure(figsize=(10, 5))
    ax1 = fig.add_subplot(121, projection="3d")
    ax2 = fig.add_subplot(122, projection="3d")

    def draw(i):
        for ax, data, title in ((ax1, pred, "prediction"), (ax2, gt, "ground truth")):
            ax.clear()
            ax.set_title(f"{title} t={i * stride}")
            pts, obs = data[i][~obstacle], data[i][obstacle]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, c="tab:blue")
            if len(obs):
                ax.scatter(obs[:, 0], obs[:, 1], obs[:, 2], s=4, c="tab:red")
        return []

    return _save(fig, plt, animation, draw, len(pred), path)


def animate_cylinder(traj_ops: Dict[str, np.ndarray], path: str, stride: int = 1) -> str:
    """2-D speed field (tripcolor): prediction (top) against ground truth
    (bottom)."""
    plt, animation = _pyplot()
    pred = np.asarray(traj_ops["pred_velocity"])[::stride]
    gt = np.asarray(traj_ops["gt_velocity"])[: len(pred) * stride : stride]
    mesh = np.asarray(traj_ops["mesh_pos"])[0]
    faces = _quad_to_tris(np.asarray(traj_ops["faces"])[0])
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6))

    def draw(i):
        for ax, data, title in ((ax1, pred, "prediction"), (ax2, gt, "ground truth")):
            ax.clear()
            ax.tripcolor(mesh[:, 0], mesh[:, 1], faces, np.linalg.norm(data[i], axis=-1), shading="gouraud")
            ax.set_title(f"{title} t={i * stride}")
            ax.set_aspect("equal")
        return []

    return _save(fig, plt, animation, draw, len(pred), path)


ANIMATIONS = {"flag": animate_flag, "plate": animate_plate, "cylinder": animate_cylinder}


def animate_rollout(
    traj_ops: Dict[str, np.ndarray], model_type: str, path: str, stride: int = 1
) -> Optional[str]:
    """The rollout's GIF at ``path``, or None (logged) when none was written."""
    try:
        return ANIMATIONS.get(model_type, animate_flag)(traj_ops, path, stride)
    except ImportError as exc:
        log.warning("no GIF written (%s): matplotlib is not installed", exc)
    except Exception:  # noqa: BLE001 — a plot never stops training; logged with its traceback
        log.exception("no GIF written: the rollout animation failed")
    return None
