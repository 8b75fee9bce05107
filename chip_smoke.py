#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU: build and check its kernels, then
serve flag MeshGraphNets (MGN-15MP) through ``Predictor``.

    python3 chip_smoke.py [--seed 0] [--out FILE.json] [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and dropped):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel source under hyper_graph_nets_tpu_torch/csrc, one
   nvcc per source, all started together (timed as set-up);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, with stated tolerances, and timed after warm-up
   (the kernel's device time from torch.profiler, the wrapper call and the
   plain version with CUDA events) beside its bound (the least time the
   card could take: bytes moved over the memory rate or operations over the
   peak rate, whichever is larger);
4. slice: ``Predictor.from_config`` on configs/flag_full_scale.yaml with RMP
   off (latent 128, 15 blocks, bf16, ``agg_vjp: fused``), seeded random
   weights, normalizers accumulated over a 40x40 synthetic flag trajectory
   (1,600 nodes, 9,282 edges); ``one_step`` on 21 frames and a 50-step
   ``rollout``, with every kernel's launch count read around that run; the
   card's ``one_step`` held against the same state on the CPU;
5. timings: one_step ms, rollout ms/step and edges/s, each with the card
   (with --profile also the device's busy share and kernel time by name);
6. the kernels' JSON line, then the device JSON line last.

Exits non-zero without a result when there is no CUDA device, or when the
port's package is not beside this file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): memory bytes/s, bf16 tensor
# FLOP/s, float32 FLOP/s outside the tensor cores.  Matched on the name
# torch reports; an H100 that is not PCIe or NVL is the SXM part.
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
)

# Tolerances of a kernel against its plain version on the same inputs.
# float32: summation order only.  bf16: both round at the same points, so
# an element differs only where a float32 sum in another order rounds the
# other way: one bf16 unit in the last place (2**-7 relative; 2**-5 absolute
# for a LayerNorm output in [4, 8) that e2 = e + LN(z3) cancels), and the
# aggregate sums a handful of such elements.
TOL = {
    "float32": {"e2": (1e-5, 1e-5), "agg": (1e-5, 1e-5)},
    "bfloat16": {"e2": (2.0**-7, 2.0**-5), "agg": (2.0**-5, 2.0**-5)},
}

# one_step on the card against the CPU (both bf16, 15 blocks): network
# outputs within 5% of the largest |output|, accelerations within 1% of the
# largest |acceleration|.
SERVE_TOL = {"net_out": 0.05, "acceleration": 0.01}

ONE_STEP_FRAMES = 21  # the batch bench.py trains on
ROLLOUT_STEPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, bw, bf16, f32 in PEAKS:
        if key in name:
            return key, bw, bf16, f32
    raise RuntimeError(f"no published peaks for card {name!r}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof):
    """(name, microseconds) of every kernel a torch.profiler run recorded."""
    import torch

    return [
        (ev.name, ev.time_range.elapsed_us())
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    ]


def kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device time per launch of the kernel whose name contains ``name``,
    traced over ``iters`` calls of ``fn`` after a warm-up: the kernel's own
    time, without the host's launch cost (which bounds a small launch timed
    back to back with CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [us for kname, us in device_kernels(prof) if name in kname]
    if len(times) != iters:
        raise RuntimeError(f"traced {len(times)} launches of {name}, expected {iters}")
    return sum(times) / iters / 1e3


def k1_inputs(dtype, B, snd, rcv, N, L, gen, device, mask=None):
    import torch

    E = len(snd)
    r = lambda *s: torch.randn(*s, generator=gen)
    u = lambda *s: (torch.rand(*s, generator=gen) * 2 - 1) / L**0.5
    return dict(
        e=r(B, E, L).to(dtype).to(device),
        sp=r(B, N, L).to(dtype).to(device),
        rp=r(B, N, L).to(dtype).to(device),
        weights={
            "we": u(L, L).to(device), "w2": u(L, L).to(device), "w3": u(L, L).to(device),
            "b1": u(L).to(device), "b2": u(L).to(device), "b3": u(L).to(device),
            "lns": (1 + 0.1 * r(L)).to(device), "lnb": (0.1 * r(L)).to(device),
        },
        senders=torch.as_tensor(snd).to(device),
        receivers=torch.as_tensor(rcv).to(device),
        mask=None if mask is None else torch.as_tensor(mask).to(device),
        num_nodes=N,
    )


def k1_bound_ms(dtype_name, B, E, N, L, peaks) -> tuple:
    """Least time for one K1 call: each input read once and each output
    written once, or the three L x L products at the peak rate."""
    _, bw, bf16_peak, f32_peak = peaks
    s = 2 if dtype_name == "bfloat16" else 4
    bytes_moved = (
        B * E * L * s * 2  # e in, e2 out
        + B * N * L * s * 2  # SP, RP in
        + B * N * 4 * L * 4  # agg out (float32)
        + E * 4 * 2 + (N + 1) * 4  # senders, receivers, row_ptr
        + 3 * L * L * s + 5 * L * 4  # weights, biases, LayerNorm
    )
    flops = 3 * 2 * B * E * L * L
    t_bytes = bytes_moved / bw * 1e3
    t_ops = flops / (bf16_peak if dtype_name == "bfloat16" else f32_peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, rtol, atol):
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max())}"
        )
    return float(err.max())


def phase_kernels(card, peaks, topo_np, seed):
    """K1 against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.ops.fused_block import (
        fused_edge_block,
        fused_edge_block_reference,
        plan_segments,
    )

    snd, rcv, N = topo_np
    L, E = 128, len(snd)
    gen = torch.Generator().manual_seed(seed)
    results = {}
    cases = [("bfloat16", ONE_STEP_FRAMES), ("float32", ONE_STEP_FRAMES), ("bfloat16", 1)]
    for dtype_name, B in cases:
        dtype = getattr(torch, dtype_name)
        x = k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda")
        plan = plan_segments(rcv, N).to("cuda")
        run = lambda: fused_edge_block(**x, plan=plan)
        e2, agg = run()
        torch.cuda.synchronize()
        re2, ragg = fused_edge_block_reference(**x)
        rt, at = TOL[dtype_name]["e2"]
        err = check_close(f"K1 {dtype_name} B={B} e2", e2, re2, rt, at)
        rt, at = TOL[dtype_name]["agg"]
        err = max(err, check_close(f"K1 {dtype_name} B={B} agg", agg, ragg, rt, at))
        if not (torch.isfinite(e2.float()).all() and torch.isfinite(agg).all()):
            raise AssertionError("K1 output not finite")
        ms = kernel_device_ms(run, iters=20, name="fused_block_fwd_kernel")
        call_ms = cuda_time_ms(run, iters=50)
        plain_ms = cuda_time_ms(lambda: fused_edge_block_reference(**x), iters=10)
        bound, bound_by = k1_bound_ms(dtype_name, B, E, N, L, peaks)
        results[(dtype_name, B)] = dict(
            max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by,
        )
        log(
            f"K1 {dtype_name} B={B} E={E} N={N} L={L}: kernel {ms * 1e3:.1f} us "
            f"(wrapper call {call_ms * 1e3:.1f} us), bound {bound * 1e3:.2f} us "
            f"({bound_by}), plain {plain_ms:.3f} ms, max abs err {err:.3g} [{card}]"
        )

    # masked tail and an isolated receiver, bf16, at the main path's width
    keep = rcv != 10
    pad = 5
    snd_m = np.concatenate([snd[keep], np.zeros(pad, np.int32)])
    rcv_m = np.concatenate([rcv[keep], np.full(pad, N - 1, np.int32)])
    mask = np.r_[np.ones(int(keep.sum())), np.zeros(pad)].astype(np.float32)
    x = k1_inputs(torch.bfloat16, 3, snd_m, rcv_m, N, L, gen, "cuda", mask=mask)
    e2, agg = fused_edge_block(**x)
    re2, ragg = fused_edge_block_reference(**x)
    check_close("K1 masked e2", e2, re2, *TOL["bfloat16"]["e2"])
    check_close("K1 masked agg", agg, ragg, *TOL["bfloat16"]["agg"])
    if not bool((agg[:, 10] == 0).all()):
        raise AssertionError("K1: isolated receiver's aggregate is not 0")
    log("K1 masked tail + isolated receiver: ok")
    return results


def phase_slice(card, seed, rollout_steps, profile_dir=None):
    """Serve MGN-15MP through the port's Predictor; returns timings and counts."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import batched_forward
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml("flag_full_scale")
    config["params"]["model"]["rmp"].update(clustering="none", connector="none")
    predictor = Predictor.from_config(config)
    model = predictor.model
    cfg = model.gnn_config
    if (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp, cfg.compute_dtype) != (
        128, 15, "fused", "bfloat16"
    ):
        raise AssertionError(f"flag_full_scale is not MGN-15MP: {cfg}")
    blocks = cfg.message_passing_steps
    # seeded weights, normalizers accumulated over the trajectory
    state = model.init_state(torch.Generator().manual_seed(seed))
    traj = add_targets(
        flag_trajectory(num_steps=rollout_steps + 3, nx=40, ny=40, seed=seed),
        "world_pos", history=True,
    )
    topo = model.topology_from_trajectory(traj, device="cpu")
    frames = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    with torch.no_grad():
        _, _, state = model.make_graph(state, topo, frames, True)
        _, state = model.get_target(state, frames, True)
    predictor.state = state.to(predictor.device)
    E, N = int(topo.senders.shape[0]), topo.num_nodes
    B = ONE_STEP_FRAMES
    batch = {k: v[:B] for k, v in traj.items()}
    log(f"slice: flag MGN-15MP latent 128 bf16, N={N} E={E}, one_step B={B}, rollout {rollout_steps}")

    # the main path: every count set to 0 just before, read just after
    fused_edge_block.launches = 0
    pred = predictor.one_step(batch)
    launches_one_step = fused_edge_block.launches
    result = predictor.rollout(traj, num_steps=rollout_steps)
    launches = fused_edge_block.launches
    if launches_one_step != blocks or launches != blocks * (1 + rollout_steps):
        raise AssertionError(
            f"K1 launches: {launches_one_step} in one_step (want {blocks}), "
            f"{launches} in all (want {blocks * (1 + rollout_steps)})"
        )
    if pred.shape != (B, N, 3) or not np.isfinite(pred).all():
        raise AssertionError(f"one_step output {pred.shape} not finite/shaped")
    if result["pred_pos"].shape != (rollout_steps, N, 3) or not (
        np.isfinite(result["pred_pos"]).all() and np.isfinite(result["mse"]).all()
    ):
        raise AssertionError("rollout output not finite/shaped")
    log(f"K1 launches on the main path: {launches_one_step} per one_step, {launches} in all")

    # the card against the CPU, same state, bf16 on both
    cpu = Predictor(config, state=predictor.state, device="cpu")
    pred_cpu = cpu.one_step(batch)
    base = 2 * batch["world_pos"] - batch["prev|world_pos"]
    acc, acc_cpu = pred - base, pred_cpu - base
    acc_err = float(np.abs(acc - acc_cpu).max())
    acc_scale = float(np.abs(acc_cpu).max())
    with torch.inference_mode():
        outs = []
        for p in (predictor, cpu):
            t = p.model.topology_from_trajectory(batch, device=p.device)
            fr = {k: torch.as_tensor(v, device=p.device) for k, v in batch.items() if k != "cells"}
            g, _, _ = p.model.make_graph(p.state, t, fr, False)
            outs.append(batched_forward(p.model, p.state.params, g).cpu())
    out_err = float((outs[0] - outs[1]).abs().max())
    out_scale = float(outs[1].abs().max())
    log(
        f"one_step card vs CPU: net out max err {out_err:.4g} of max {out_scale:.4g}; "
        f"acceleration max err {acc_err:.4g} of max {acc_scale:.4g}"
    )
    if out_err > SERVE_TOL["net_out"] * out_scale or acc_err > SERVE_TOL["acceleration"] * acc_scale:
        raise AssertionError(f"one_step card vs CPU outside tolerance {SERVE_TOL}")

    # timings (host clock around synchronized work)
    one_step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.one_step(batch)
        one_step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.rollout(traj, num_steps=rollout_steps)
    rollout_s = time.perf_counter() - t0
    one_step_ms = 1e3 * float(np.median(one_step_s))
    rollout_ms_step = 1e3 * rollout_s / rollout_steps
    timings = dict(
        one_step_ms=one_step_ms,
        one_step_edges_per_s=B * E / (one_step_ms / 1e3),
        rollout_ms_per_step=rollout_ms_step,
        rollout_edges_per_s=E / (rollout_ms_step / 1e3),
        one_step_vs_cpu_net_out_err=out_err,
        one_step_vs_cpu_acceleration_err=acc_err,
    )
    log(
        f"one_step B={B}: {one_step_ms:.2f} ms, {timings['one_step_edges_per_s']:.4g} edges/s [{card}]"
    )
    log(
        f"rollout: {rollout_ms_step:.2f} ms/step, {timings['rollout_edges_per_s']:.4g} edges/s [{card}]"
    )
    if profile_dir:
        timings["profile"] = {
            "one_step": device_profile(lambda: predictor.one_step(batch), card, profile_dir, "one_step"),
            "rollout_5_steps": device_profile(
                lambda: predictor.rollout(traj, num_steps=5), card, profile_dir, "rollout"
            ),
        }
    return {"fused_edge_block": launches}, timings


def device_profile(fn, card, out_dir, name, top=8):
    """One traced run of ``fn``: device busy share and kernel time by name.

    Kernels run on one stream, so their summed durations are the device's
    busy time; the rest of the host-clock window is idle.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for kname, us in device_kernels(prof):
        t, n = by_name.get(kname, (0.0, 0))
        by_name[kname] = (t + us, n + 1)
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    log(
        f"profile {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(n for _, n in by_name.values())} kernels [{card}]"
    )
    for kname, (t, n) in rows[:top]:
        log(f"  {100 * t / busy_us:5.1f}%  {t / 1e3:8.3f} ms  x{n:<5d} {kname[:100]}")
    return {
        "wall_ms": wall_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "kernels": [{"name": k, "ms": t / 1e3, "count": n} for k, (t, n) in rows],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument(
        "--profile", metavar="DIR",
        help="also trace one one_step and a 5-step rollout with torch.profiler "
        "(device busy share, kernel time by name; Chrome traces into DIR)",
    )
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hyper_graph_nets_tpu_torch")):
        print("chip_smoke: the port's package is not beside this file", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
    from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    # 1. device
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    log(f"card: {kind}; nvidia-smi: {card}; peaks used: {peaks[0]} "
        f"({peaks[1] / 1e12:.2f} TB/s, {peaks[2] / 1e12:.0f} bf16 TFLOP/s, "
        f"{peaks[3] / 1e12:.0f} f32 TFLOP/s)")
    configure_numerics()

    # 2. build every kernel source, all nvcc processes at once
    sources = sorted(
        build.source_path(n) for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu")
    )
    t0 = time.perf_counter()
    build.build(sources)
    log(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {os.path.basename(src)}: {line.strip()}")

    # 3. kernels against their plain versions
    edges = cells_to_edges(_grid_triangulation(40, 40))
    k1 = phase_kernels(card, peaks, (edges.senders, edges.receivers, 1600), args.seed)

    # 4-5. the slice, its counts and timings
    launches, timings = phase_slice(card, args.seed, ROLLOUT_STEPS, args.profile)

    main_k1 = k1[("bfloat16", ONE_STEP_FRAMES)]
    kernels = [
        {
            "name": "fused_edge_block_fwd (K1)",
            "route": "cuda",
            "source": "hyper_graph_nets_tpu_torch/csrc/fused_block_fwd.cu",
            "replaces": "hyper_graph_nets_tpu/ops/pallas/fused_block.py:393",
            "launches": launches["fused_edge_block"],
            "max_abs_err": main_k1["max_abs_err"],
            "ms": main_k1["ms"],
            "plain_ms": main_k1["plain_ms"],
            "bound_ms": main_k1["bound_ms"],
            "bound_by": main_k1["bound_by"],
            "library_ms": None,
        }
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(
                {
                    "card": card,
                    "kind": kind,
                    "k1": {f"{d} B={b}": v for (d, b), v in k1.items()},
                    "timings": timings,
                    "kernels": kernels,
                },
                f, indent=1,
            )
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
