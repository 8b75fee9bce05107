"""Rollout animations as GIFs.

Counterpart of ``hyper_graph_nets_tpu/utils/viz.py`` for flag: a 3-D
trisurf animation of the predicted cloth beside the ground truth, written
with PillowWriter.  matplotlib is imported inside the function, so the
port imports and runs without it: :func:`animate_rollout` then writes no
GIF, logs why and returns None, as the JAX package's does on any failure.
The plate and cylinder animations come with the plate and cylinder slice
(ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


def animate_flag(traj_ops: Dict[str, np.ndarray], path: str, stride: int = 1) -> str:
    """3-D cloth animation: prediction (left) against ground truth (right)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    pred = np.asarray(traj_ops["pred_pos"])[::stride]
    gt = np.asarray(traj_ops["gt_pos"])[: len(pred) * stride : stride]
    faces = np.asarray(traj_ops["faces"])[0]
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

    try:
        anim = animation.FuncAnimation(fig, draw, frames=len(pred), interval=100)
        anim.save(path, writer=animation.PillowWriter(fps=10))
    finally:
        plt.close(fig)
    return path


def animate_rollout(
    traj_ops: Dict[str, np.ndarray], model_type: str, path: str, stride: int = 1
) -> Optional[str]:
    """The rollout's GIF at ``path``, or None (logged) when none was written."""
    if model_type != "flag":
        log.warning("no %s rollout animation in the port yet; no GIF written", model_type)
        return None
    try:
        return animate_flag(traj_ops, path, stride)
    except ImportError as exc:
        log.warning("no GIF written (%s): matplotlib is not installed", exc)
    except Exception:  # noqa: BLE001 — a plot never stops training; logged with its traceback
        log.exception("no GIF written: the rollout animation failed")
    return None
