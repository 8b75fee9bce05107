"""How the RMP train step's float32 gradients, card against CPU, spread
over the mesh tier and the cluster tier as the number of hyper rows grows,
on an H100.

``chip_smoke.phase_rmp`` holds the cluster tier (``chip_smoke.RMP_TIER``:
the hyper encoder and node models and the up, inter and down edge models)
to a looser limit than the mesh tier, on the reading that each of those
tensors is fed by the B x K hyper rows (B frames, K clusters): a relu input
within one rounding of 0 that flips in one of them moves a whole cluster's
share.  If that is so, the cluster tier's error falls toward the mesh
tier's as B x K grows, and the mesh tier's stays where it is.  This tool
reads it: ``flag_full_scale`` as shipped (float32, 15 hierarchical blocks,
latent 128), the same converted state, noise and static on both sides, at
each ``B:K`` of ``--cases``; per case the loss's relative error, the mesh
tier's worst gradient (relative L2) and each cluster-tier group's worst.

    python tools/torch_port/rmp_tier_spread.py [--cases 2:16,2:64,8:16]

Prints a line per case and one JSON line with every reading.
"""
import argparse
import json
import os
import sys

SIDES = {"cpu": "cpu", "card": "cuda"}

def run_case(cs, B, K, seed=0):
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    config = cs.rmp_config(compute_dtype=None)
    config["params"]["model"]["rmp"]["num_clusters"] = K
    traj = add_targets(flag_trajectory(num_steps=B + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    frame0 = {k: v[0] for k, v in traj.items()}
    model = get_model(config)
    state = cs.rmp_state(config, traj, seed + 1)
    gen = torch.Generator().manual_seed(seed + 2)
    normal = torch.randn(traj["world_pos"].shape, generator=gen)
    runs, static, hyper = {}, None, None
    for side, device in SIDES.items():
        tr = Trainer(model, config, device=device)
        topo = model.topology_from_trajectory(traj, device=device)
        frames = tr.frames(traj)
        if static is None:
            static = tr.expansion.prepare(model, frame0, topo)
            hyper = torch.randn(tr.expansion.hyper_noise_shape(model, frames, static), generator=gen)
        st = tuple(s.to(device) for s in static)
        ts = tr.init_train_state(state=state)
        loss, _ = tr.loss_and_grads(ts, topo, frames, normal=normal.to(device), static=st,
                                    hyper_normal=hyper.to(device))
        runs[side] = (float(loss), {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()})
    (lc, gc), (lg, gg) = runs["cpu"], runs["card"]
    errs = {n: cs.rel_l2(gg[n], gc[n]) for n in gc}
    out = {"B": B, "K": K, "loss": abs(lg - lc) / abs(lc),
           "mesh tier": max(e for n, e in errs.items() if not any(t in n for t in cs.RMP_TIER))}
    for t in cs.RMP_TIER:
        out[t] = max(e for n, e in errs.items() if t in n)
    worst = sorted(((e, n) for n, e in errs.items()), reverse=True)[:4]
    cs.log(f"float32 card vs CPU, B={B} K={K}: " + ", ".join(
        f"{k} {v:.3g}" for k, v in out.items() if k not in ("B", "K"))
        + "; worst " + ", ".join(f"{e:.3g} {n}" for e, n in worst))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="2:16,2:64,8:16", help="B:K pairs, comma-separated")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rmp_tier_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    card = cs.nvidia_smi()
    configure_numerics()
    build.build([build.source_path(n) for n in ("fused_block_fwd.cu", "fused_block_bwd.cu")])
    readings = []
    for case in args.cases.split(","):
        B, K = map(int, case.split(":"))
        readings.append(run_case(cs, B, K))
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
