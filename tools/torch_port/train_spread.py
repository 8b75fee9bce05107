"""The spread of ``chip_smoke.py``'s train-step check over repeated card runs.

``chip_smoke.phase_train`` holds one train step of flag MGN-15MP (B = 2 on
the 40x40 flag) on the card against the same step on the CPU: same state,
noise and, with the balancer, the same static; its loss and each parameter's
gradient (relative L2) within ``chip_smoke.TRAIN_TOL``.  Both sides run with
PyTorch's deterministic algorithms (``chip_smoke.fixed_scatter_order``).

This runs the card side of that comparison for the path with the Ricci
balancer, in float32 (where every tensor is held to the same limit), again
and again: first as it comes (no deterministic-algorithms setting; before
the port's fixed-order sums, ``core.segment_ops.FixedSum``, the balance set
went through PyTorch's atomic scatter-adds there), then under PyTorch's
deterministic algorithms, each against one CPU run made in a fixed order.  It prints how many card runs read each worst
gradient relative L2 (3 significant digits), the loss readings, and the four
worst tensors of the worst run.

Run from the root of a checkout, on the card:

    python tools/torch_port/train_spread.py [--seconds 300] [--fixed-seconds 60]
"""
import argparse
import collections
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def spread(seconds=300.0, fixed_seconds=60.0, device="cuda", nx=40, model=None, max_runs=None):
    """``{"atomic": ..., "fixed": ..., "names": the parameters compared}``,
    each order ``{"worst": Counter of the worst gradient relative L2 of each
    card run, "loss": Counter of its loss relative error, "runs": n, "top":
    the worst run's four worst (err, name)}``; ``model`` overrides keys of
    the configuration's model (a small test)."""
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    seed = 0  # chip_smoke.py's default --seed
    extra = dict(model or {}, fused_bwd="remat")
    traj = add_targets(flag_trajectory(num_steps=cs.TRAIN_FRAMES + 2, nx=nx, ny=nx, seed=seed), "world_pos",
                       history=True)
    # as phase_train: the static of the training model's prepare on the first frame
    config = cs.balancer_config(**extra)
    main_model = get_model(config)
    trainer = Trainer(main_model, config, device=device)
    topo = main_model.topology_from_trajectory(traj, device=device)
    static = trainer.expansion.prepare(main_model, {k: v[0] for k, v in traj.items()}, topo)
    cmp_config = cs.balancer_config(**extra, compute_dtype=None)
    cmp_model = get_model(cmp_config)
    state = cmp_model.init_state(torch.Generator().manual_seed(seed + 1))
    small = {k: v[: cs.CPU_FRAMES] for k, v in traj.items()}
    normal = torch.randn(small["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 2),
                         dtype=torch.float64)

    def step(where):
        tr = Trainer(cmp_model, cmp_config, device=where)
        ts = tr.init_train_state(state=state)
        t = cmp_model.topology_from_trajectory(small, device=where)
        loss, _ = tr.loss_and_grads(ts, t, tr.frames(small), normal=normal.to(where), static=static)
        return float(loss), {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()}

    with cs.fixed_scatter_order():
        cpu_loss, cpu_grads = step("cpu")
    out = {"names": sorted(cpu_grads)}
    for order, budget in (("atomic", seconds), ("fixed", fixed_seconds)):
        worst, losses, top, runs = collections.Counter(), collections.Counter(), [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget and (max_runs is None or runs < max_runs):
            if order == "fixed":
                with cs.fixed_scatter_order():
                    loss, grads = step(device)
            else:
                loss, grads = step(device)
            errs = sorted(((cs.rel_l2(grads[n], g), n) for n, g in cpu_grads.items()), reverse=True)
            worst[f"{errs[0][0]:.3g}"] += 1
            losses[f"{abs(loss - cpu_loss) / abs(cpu_loss):.3g}"] += 1
            if not top or errs[0][0] > top[0][0]:
                top = errs[:4]
            runs += 1
        out[order] = {"worst": worst, "loss": losses, "runs": runs, "top": top}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0, help="card runs with atomic scatter-adds")
    ap.add_argument("--fixed-seconds", type=float, default=60.0, help="card runs in a fixed order")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_spread: no CUDA device", file=sys.stderr)
        return 2
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    configure_numerics()
    card = cs.nvidia_smi()
    build.build(sorted(build.source_path(n) for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu")))
    res = spread(args.seconds, args.fixed_seconds)
    limit = cs.TRAIN_TOL["float32"][1]
    for order in ("atomic", "fixed"):
        r = res[order]
        over = sum(n for w, n in r["worst"].items() if float(w) > limit)
        print(f"balancer float32, scatter-adds {order}: {r['runs']} card runs; worst gradient relative L2 "
              f"(runs): {sorted(r['worst'].items(), key=lambda kv: float(kv[0]))}; over {limit}: {over}; loss "
              f"relative error (runs): {sorted(r['loss'].items(), key=lambda kv: float(kv[0]))}; worst run: "
              f"{[(f'{e:.4g}', n) for e, n in r['top']]} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
