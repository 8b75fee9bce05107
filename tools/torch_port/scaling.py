"""Edges/s of the port's sharded train step over data x graph rank groups.

The port's counterpart of bench_scaling.py: flag MGN-15MP (configs/
flag_full_scale.yaml with RMP off: latent 128, 15 blocks, bf16, agg_vjp
fused, remat), the synthetic 40x40 flag (1,600 nodes, 9,282 edges), 8
frames per data rank, trained through
``parallel.sharding.make_spmd_train_step`` on every group shape of 1, 2
and 4 ranks (and 1 x 4 with K7's overlap bands).  One JSON line per shape:
ms per step (host clock, Adam included, after warm-up), edges/s (frames x
9,282 / step s) and padded edges/s (frames x the padded edge count, as
bench_scaling.py counts), ``devices_attached`` (the cards this process
sees) and ``ranks_per_card``.

Rank r sits on ``cuda:(r % cards)`` (the default ``RankGroup``): on one
card every rank of a group shares it, and such a row times the rank
group's launch path and the kernels' ring protocol, not scaling; its
``scaling_efficiency`` is null.  Only where every rank has a card of its
own (``ranks_per_card`` 1) is the efficiency (edges/s at n ranks over n
times edges/s at one rank) a scaling result.

    python tools/torch_port/scaling.py [--steps 5] [--warmup 2] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

FRAMES_PER_DATA_RANK = 8  # bench_scaling.py's BATCH_PER_DEVICE
GRID = 40
SHAPES = ((1, 1, None), (2, 1, None), (1, 2, None), (4, 1, None), (2, 2, None), (1, 4, None), (1, 4, 4))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure(data: int, graph: int, bands, steps: int, warmup: int, seed: int) -> dict:
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml("flag_full_scale")
    config["params"]["model"]["rmp"].update(clustering="none", connector="none")
    model = get_model(config)
    trainer = Trainer(model, config)
    batch = FRAMES_PER_DATA_RANK * data
    traj = add_targets(flag_trajectory(num_steps=batch + 2, nx=GRID, ny=GRID, seed=seed), "world_pos", history=True)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames({k: v[:batch] for k, v in traj.items() if k != "cells"})
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tstate = trainer.init_train_state(generator=torch.Generator().manual_seed(seed))
    group = RankGroup(data, graph)
    stopo = shard_topology(topo, group, overlap_bands=bands)
    step = make_spmd_train_step(trainer, stopo, group)
    for _ in range(warmup):
        tstate, loss = step(tstate, frames, generator=gen)
    group.check()
    t0 = time.perf_counter()
    for _ in range(steps):
        tstate, loss = step(tstate, frames, generator=gen)
    group.check()
    dt = (time.perf_counter() - t0) / steps
    E, E_pad = int(topo.senders.shape[0]), int(stopo.senders.shape[0])
    cards = torch.cuda.device_count()
    return {
        "ranks": data * graph,
        "group": f"{data}x{graph}" + (f" overlap {bands}" if bands else ""),
        "batch": batch,
        "ms_per_step": dt * 1e3,
        "edges_per_s": batch * E / dt,
        "padded_edges_per_s": batch * E_pad / dt,
        "loss": float(loss),
        "devices_attached": cards,
        "ranks_per_card": max(group.ranks_on_device(r) for r in range(group.n)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scaling: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    rows = [measure(d, g, b, args.steps, args.warmup, args.seed) for d, g, b in SHAPES]
    base = rows[0]
    for r in rows:
        # one card standing in for several measures no scaling
        own = r["ranks_per_card"] == 1
        r["scaling_efficiency"] = r["edges_per_s"] / (r["ranks"] * base["edges_per_s"]) if own else None
        r["card"] = card
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
