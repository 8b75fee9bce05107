"""Synthetic mesh-physics trajectories (numpy).

Counterpart of ``hyper_graph_nets_tpu/data/synthetic.py``, with the keys of
the DeepMind datasets and the ``meta.json`` schema of generated data:

- flag: mass-spring cloth on a triangulated grid, pinned at two corners,
  under gravity and a seeded wind (flag_simple);
- cylinder: a decaying, oscillating velocity field and a pressure field on a
  triangulated channel with a circular wall obstacle (cylinder_flow);
- plate: a quad-cell plate pressed by a descending kinematic stamp whose
  nodes have no mesh edges (deforming_plate), close enough that world edges
  form.

Same seed, same arrays as the JAX package's generators, byte for byte.
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


def cylinder_trajectory(
    num_steps: int = 50, nx: int = 10, ny: int = 6, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Channel flow past an obstacle; velocity(2) + pressure(1) fields."""
    rng = np.random.RandomState(seed)
    n = nx * ny
    xs, ys = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 1, ny), indexing="ij")
    mesh_pos = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    cells = _grid_triangulation(nx, ny)

    node_type = np.full((n, 1), NodeType.NORMAL, np.int32)
    node_type[mesh_pos[:, 0] < 1e-6] = NodeType.INFLOW
    node_type[mesh_pos[:, 0] > 2 - 1e-6] = NodeType.OUTFLOW
    wall = (mesh_pos[:, 1] < 1e-6) | (mesh_pos[:, 1] > 1 - 1e-6)
    node_type[wall & (node_type[:, 0] == NodeType.NORMAL)] = NodeType.WALL_BOUNDARY
    center = np.array([0.7, 0.5])
    obstacle = np.linalg.norm(mesh_pos - center, axis=1) < 0.18
    node_type[obstacle] = NodeType.WALL_BOUNDARY

    # analytic-ish decaying oscillating flow field
    t = np.arange(num_steps, dtype=np.float32)[:, None, None]
    base = np.stack(
        [1.0 - 0.5 * (mesh_pos[:, 1] - 0.5) ** 2, 0.1 * np.sin(4 * mesh_pos[:, 0])],
        axis=1,
    )[None]
    wiggle = 0.1 * np.sin(0.3 * t + mesh_pos[:, 0][None, :, None] * 3.0)
    velocity = (base + wiggle).astype(np.float32)
    velocity[:, node_type[:, 0] == NodeType.WALL_BOUNDARY] = 0.0
    velocity += 0.01 * rng.randn(*velocity.shape).astype(np.float32)
    pressure = (
        0.5 * np.cos(2 * mesh_pos[:, 0])[None, :, None]
        + 0.05 * np.cos(0.3 * t + mesh_pos[:, 1][None, :, None])
    ).astype(np.float32)

    T = num_steps
    return {
        "cells": np.tile(cells[None], (T, 1, 1)),
        "mesh_pos": np.tile(mesh_pos[None], (T, 1, 1)),
        "node_type": np.tile(node_type[None], (T, 1, 1)),
        "velocity": velocity,
        "pressure": pressure,
    }


# plate obstacle motion: start just above the plate, descend at OBS_RATE
# per step, hold at OBS_Z_MIN.  OBS_CLEARANCE (< world-edge radius 0.03)
# is the gap the pressed plate keeps to the stamp, so contact frames have
# real world edges at every mesh resolution.
OBS_Z0 = 0.05
OBS_RATE = 0.005
OBS_Z_MIN = 0.004
OBS_CLEARANCE = 0.015


def plate_trajectory(
    num_steps: int = 30, nx: int = 6, ny: int = 6, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Quad-cell plate pressed by a kinematic obstacle stamp (3D contact)."""
    rng = np.random.RandomState(seed)
    n_plate = nx * ny
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    plate_mesh = np.stack(
        [xs.ravel(), ys.ravel(), np.zeros(n_plate)], axis=1
    ).astype(np.float32)

    # obstacle: a flat square stamp above the plate, pressing down.  The
    # stamp scales with the mesh so contact stays resolved at every
    # resolution; it descends INTO world-edge range (radius 0.03,
    # models/plate.WORLD_EDGE_RADIUS) so the contact path the reference
    # exercises on the real deforming_plate data (world edges) actually
    # fires.
    side = max(3, nx // 9)
    n_obs = side * side
    # snap the stamp center to the nearest grid node so the center stamp
    # point has a plate node directly beneath it at EVERY resolution
    # (coarse grids have no node near (0.5, 0.5) otherwise — e.g. nx=6)
    cx = round(0.5 * (nx - 1)) / (nx - 1)
    cy = round(0.5 * (ny - 1)) / (ny - 1)
    g = (np.arange(side) - (side - 1) / 2.0) * 0.04
    ox, oy = np.meshgrid(cx + g, cy + g, indexing="ij")
    obs_mesh = np.stack(
        [ox.ravel(), oy.ravel(), OBS_Z0 * np.ones(n_obs)], axis=1
    ).astype(np.float32)

    mesh_pos = np.concatenate([plate_mesh, obs_mesh], axis=0)
    n = n_plate + n_obs
    node_type = np.full((n, 1), NodeType.NORMAL, np.int32)
    node_type[n_plate:, 0] = NodeType.OBSTACLE
    boundary = (
        (plate_mesh[:, 0] < 1e-6)
        | (plate_mesh[:, 0] > 1 - 1e-6)
        | (plate_mesh[:, 1] < 1e-6)
        | (plate_mesh[:, 1] > 1 - 1e-6)
    )
    node_type[:n_plate][boundary] = NodeType.HANDLE

    # quad cells over the plate grid
    quads = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + j + 1
            d = i * ny + j + 1
            quads.append([a, b, c, d])
    cells = np.asarray(quads, np.int32)

    T = num_steps
    world = np.tile(mesh_pos[None], (T, 1, 1)).astype(np.float32)
    drop = np.minimum(OBS_Z0 - OBS_Z_MIN, OBS_RATE * np.arange(T, dtype=np.float32))
    world[:, n_plate:, 2] -= drop[:, None]
    # plate surface follows the descending stamp with a small clearance
    # (< world-edge radius), so pressed nodes stay inside radius-0.03 of
    # the stamp points: genuine world edges form once obs_z < 0.03 and
    # persist through the hold phase at OBS_Z_MIN
    r = np.linalg.norm(plate_mesh[:, :2] - np.array([cx, cy]), axis=1)
    for t in range(T):
        obs_z = world[t, n_plate:, 2].min()
        target = (obs_z - OBS_CLEARANCE) * np.exp(-((r / 0.18) ** 2))
        dented = np.minimum(world[t, :n_plate, 2], target)
        world[t, :n_plate, 2] = np.where(boundary, world[t, :n_plate, 2], dented)
    world += 0.002 * rng.randn(*world.shape).astype(np.float32)
    world[:, node_type[:, 0] == NodeType.HANDLE] = np.tile(
        mesh_pos[node_type[:, 0] == NodeType.HANDLE][None], (T, 1, 1)
    )

    return {
        "cells": np.tile(cells[None], (T, 1, 1)),
        "mesh_pos": np.tile(mesh_pos[None], (T, 1, 1)),
        "node_type": np.tile(node_type[None], (T, 1, 1)),
        "world_pos": world,
    }


GENERATORS = {
    "flag_minimal": flag_trajectory,
    "flag_simple": flag_trajectory,
    "cylinder_flow": cylinder_trajectory,
    "deforming_plate": plate_trajectory,
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

