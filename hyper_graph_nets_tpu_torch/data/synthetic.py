"""Synthetic flag trajectories (numpy).

Counterpart of ``hyper_graph_nets_tpu/data/synthetic.py`` for flag:
mass-spring cloth on a triangulated grid, pinned at two corners, under
gravity and a seeded wind, with the keys of the flag_simple dataset, and the
``meta.json`` schema of generated data.  Same seed, same arrays as the JAX
package's generator.  The cylinder and plate generators come with the
plate and cylinder slice of the port (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from hyper_graph_nets_tpu_torch.core.graph import NodeType
from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges


def _grid_triangulation(nx: int, ny: int) -> np.ndarray:
    """Triangulate an nx x ny vertex grid into 2*(nx-1)*(ny-1) triangles."""
    cells = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = i * ny + j + 1
            d = (i + 1) * ny + j + 1
            cells.append([a, b, c])
            cells.append([b, d, c])
    return np.asarray(cells, np.int32)


def flag_trajectory(
    num_steps: int = 50,
    nx: int = 8,
    ny: int = 8,
    seed: int = 0,
    dt: float = 0.02,
) -> Dict[str, np.ndarray]:
    """Cloth pinned at two corners under gravity + wind. Keys mirror flag_simple."""
    rng = np.random.RandomState(seed)
    n = nx * ny
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    mesh_pos = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    world = np.concatenate([mesh_pos, np.zeros((n, 1), np.float32)], axis=1)

    node_type = np.zeros((n, 1), np.int32)
    node_type[0, 0] = NodeType.HANDLE
    node_type[(nx - 1) * ny, 0] = NodeType.HANDLE
    pinned = node_type[:, 0] != NodeType.NORMAL

    cells = _grid_triangulation(nx, ny)
    edges = cells_to_edges(cells)
    snd, rcv = edges.unique_senders, edges.unique_receivers
    rest = np.linalg.norm(mesh_pos[snd] - mesh_pos[rcv], axis=1)

    pos = world.copy()
    prev = world.copy()
    gravity = np.array([0.0, 0.0, -0.5], np.float32)
    wind = np.array([0.3, 0.0, 0.1], np.float32) + 0.1 * rng.randn(3).astype(np.float32)

    traj = [pos.copy()]
    k = 200.0
    for _ in range(num_steps - 1):
        force = np.tile(gravity + wind, (n, 1))
        delta = pos[snd] - pos[rcv]
        dist = np.linalg.norm(delta, axis=1, keepdims=True) + 1e-9
        f = k * (dist - rest[:, None]) * delta / dist
        np.add.at(force, rcv, f)
        np.add.at(force, snd, -f)
        nxt = 2 * pos - prev + dt * dt * force
        nxt[pinned] = world[pinned]
        prev, pos = pos, nxt
        traj.append(pos.copy())

    world_pos = np.stack(traj).astype(np.float32)
    T = num_steps
    return {
        "cells": np.tile(cells[None], (T, 1, 1)),
        "mesh_pos": np.tile(mesh_pos[None], (T, 1, 1)),
        "node_type": np.tile(node_type[None], (T, 1, 1)),
        "world_pos": world_pos,
    }


GENERATORS = {
    "flag_minimal": flag_trajectory,
    "flag_simple": flag_trajectory,
}


def make_meta(dataset: str, trajectory: Dict[str, np.ndarray]) -> dict:
    """A DeepMind-style meta.json dict for generated data."""
    features = {}
    T = trajectory["cells"].shape[0]
    for key, val in trajectory.items():
        static = key in ("cells", "mesh_pos", "node_type")
        features[key] = {
            "type": "static" if static else "dynamic",
            "shape": [1 if static else T] + list(val.shape[1:]),
            "dtype": str(val.dtype),
        }
    return {"dataset": dataset, "trajectory_length": T, "features": features}

