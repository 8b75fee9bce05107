"""Serving and training times of the flag MGN-15MP paths (fused, sorted,
fused + Ricci balancer) for the checkout the command runs in, on an H100.

Run from the root of a checkout (it imports that checkout's
``chip_smoke.py`` and port), with a tag for the output lines; to compare
two commits, unpack both and run them in turns in one call (parent,
change, change, parent):

    python tools/torch_port/path_times.py change [--paths fused,sorted,balancer] [--traces DIR]
    (cd parent_checkout && python ../tools/torch_port/path_times.py parent)

Each path is ``chip_smoke.main_config`` (or ``balancer_config``) on the
40x40 flag with seeded weights.  For each: ``Predictor.one_step`` at B=21
with a prepared static (host clock, median of 10 after 3 warm-up calls)
and ``Trainer.train_step`` at B=21 (median of 10 after 3 warm-up steps),
then one traced call of each (``chip_smoke.device_profile``: device busy
time, launches, and the kernels' time by name, the top ones printed).
Prints one JSON line per path, ``{"tag", "path", "card", "one_step_ms",
"train_step_ms", "one_step", "train_step"}``, the last two the traced
call's wall and busy ms and its kernel count.
"""
import argparse
import json
import os
import sys
import time

WARMUP, TIMED = 3, 10


def host_ms(fn, torch, n=TIMED, warmup=WARMUP):
    import numpy as np

    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def run_path(cs, path, tag, card, traces, seed=0):
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    balancer = path == "balancer"
    kw = dict(agg_vjp="sorted") if path == "sorted" else {}
    config = cs.balancer_config(**kw) if balancer else cs.main_config(**kw)
    B = cs.TRAIN_FRAMES
    traj = add_targets(flag_trajectory(num_steps=B + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    frame0 = {k: v[0] for k, v in traj.items()}

    predictor = Predictor.from_config(config)
    model = predictor.model
    state = model.init_state(torch.Generator().manual_seed(seed))
    topo = model.topology_from_trajectory(traj, device="cpu")
    frames = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    with torch.no_grad():
        _, _, state = model.make_graph(state, topo, frames, True)
        _, state = model.get_target(state, frames, True)
    predictor.state = state.to(predictor.device)
    batch = {k: v[:B] for k, v in traj.items()}
    predictor.one_step(batch)
    static = predictor.expansion.static if balancer else None
    serve = lambda: predictor.one_step(batch, static=static)
    one_step_ms = host_ms(serve, torch)
    one_step_prof = cs.device_profile(serve, card, traces, f"{tag}_one_step_{path}")

    model = get_model(config)
    trainer = Trainer(model, config)
    tstate = trainer.init_train_state(torch.Generator().manual_seed(seed))
    ttopo = model.topology_from_trajectory(traj, device=trainer.device)
    tframes = trainer.frames(traj)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tstatic = trainer.expansion.prepare(model, frame0, ttopo) if balancer else None
    box = [tstate]

    def step():
        box[0], _ = trainer.train_step(box[0], ttopo, tframes, generator=gen, static=tstatic)

    train_ms = host_ms(step, torch)
    train_prof = cs.device_profile(step, card, traces, f"{tag}_train_{path}")
    summary = lambda p: {"wall_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
                         "kernels": sum(k["count"] for k in p["kernels"])}
    return {"tag": tag, "path": path, "card": card, "one_step_ms": one_step_ms, "train_step_ms": train_ms,
            "one_step": summary(one_step_prof), "train_step": summary(train_prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--paths", default="fused,sorted,balancer")
    ap.add_argument("--traces", default=os.path.join("_chipcopy", "traces"),
                    help="directory for the Chrome traces (tens of MB a run)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    card = cs.nvidia_smi()
    configure_numerics()
    build.build(sorted(build.source_path(n) for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu")))
    for path in args.paths.split(","):
        r = run_path(cs, path, args.tag, card, os.path.abspath(args.traces))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
