"""What ``model.remat: true`` costs and saves on the card.

For configs/flag_full_scale.yaml with RMP off (bf16, B = 21, 15 blocks,
fused remat: K1 + K2) and configs/cylinder.yaml (float32, B = 16, 5 blocks)
as shipped, one train step's loss and gradients without and with
``model.remat``, from one seeded state and noise: the gradients bit for bit
(the run exits 1 otherwise), each step's peak device memory
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``), its
host ms (median of 5 after 2 warm-up steps, synchronized) and its K1 and K2
launches.  Prints one JSON line per config and the card's name and power
limit.  Run from the repository's root, on the card:

    python tools/torch_port/remat_memory.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def step_readings(config, traj, frames_n, seed):
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    out = {}
    for remat in (False, True):
        config["params"]["model"]["remat"] = remat
        model = get_model(config)
        trainer = Trainer(model, config)
        state = model.init_state(torch.Generator().manual_seed(seed))
        topo = model.topology_from_trajectory(traj, device=trainer.device)
        frames = trainer.frames({k: v[:frames_n] for k, v in traj.items()})
        normal = torch.randn(frames[model.field].shape, generator=torch.Generator().manual_seed(seed + 1)).cuda()
        tstate = trainer.init_train_state(state=state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fb.fused_edge_block.launches = fb.fused_edge_block_bwd.launches = 0
        loss, _ = trainer.loss_and_grads(tstate, topo, frames, normal=normal)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {"K1": fb.fused_edge_block.launches, "K2": fb.fused_edge_block_bwd.launches}
        grads = {n: p.grad.clone() for n, p in tstate.model.params.named_parameters()}
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.loss_and_grads(tstate, topo, frames, normal=normal)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        out[remat] = dict(loss=float(loss), grads=grads, peak_mib=peak / 2**20, launches=launches,
                          ms=1e3 * float(np.median(times)))
    same = out[False]["loss"] == out[True]["loss"] and all(
        torch.equal(out[False]["grads"][n], g) for n, g in out[True]["grads"].items())
    return {
        "bit_for_bit": bool(same),
        **{f"{'remat' if r else 'plain'}_{k}": v[k] for r, v in out.items() for k in ("peak_mib", "ms", "launches")},
    }


def main() -> int:
    import torch

    from hyper_graph_nets_tpu_torch.data import synthetic
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    if not torch.cuda.is_available():
        print("remat_memory: no CUDA device", file=sys.stderr)
        return 2
    configure_numerics()
    build.build(sorted(build.source_path(n) for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu")))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    flag = read_yaml("flag_full_scale")
    flag["params"]["model"]["rmp"].update(clustering="none", connector="none")
    cases = {
        "flag_full_scale (RMP off), bf16 B=21": (
            flag, add_targets(synthetic.flag_trajectory(num_steps=23, nx=40, ny=40), "world_pos", True), 21),
        "cylinder, float32 B=16": (
            read_yaml("cylinder"),
            add_targets(synthetic.cylinder_trajectory(num_steps=18, nx=59, ny=32), "velocity", False), 16),
    }
    ok = True
    for name, (config, traj, n) in cases.items():
        r = step_readings(config, traj, n, seed=0)
        ok &= r["bit_for_bit"]
        print(json.dumps({"config": name, **r, "card": card}))
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
