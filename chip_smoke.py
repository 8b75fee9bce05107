#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU: build and check its kernels, serve
flag MeshGraphNets (MGN-15MP) through ``Predictor`` and through the halo
forward over a rank group, and train it through ``Trainer``, without and with
the Ricci graph balancer.

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
   peak rate, whichever is larger).  K1 with and without its streams, at
   B = 21 and B = 1 and raw on both halo shard layouts; K2
   (remat backward) and K3 (stream backward) at B = 21 in bf16 and float32,
   with a masked tail and an isolated receiver, with masked edges inside
   segments (as the balancer removes mesh edges), with exactly tied edges,
   at B = 1, and the routed max/min mass against the exact tie count of
   K1's output, each timed as its three kernels and as each alone;
   the float32 weight-gradient products of one block; K4f and K4b (the
   sorted pna of ``agg_vjp: sorted``) at B = 21 in bf16 and float32 and at
   B = 1, with a masked tail and an isolated receiver, masked edges inside
   segments, exactly tied edges and the routed max/min mass against the tie
   count of K4f's output, timed beside four ``torch.segment_reduce`` calls
   on the same inputs (context only: the port never calls them); K5 (the
   (max, x) product of the balanced-Forman curvature) bit for bit on the
   40x40 flag's operands in both orders, on random inputs at 1,600 cubed and
   on odd shapes; SDRF on the 40x40 flag (150 loops, tau 150, removal)
   through K5 and through K5's plain version: the same edges; K6 (the ring
   all-reduce) bit for bit with its plain version for 2, 3 and 4 ranks on
   the card at the halo payload [6400, 128] float32 with the pna segments,
   on an odd shape, with one rank's launch delayed and over 100 calls in a
   row, timed per ring ungated and gated (CUDA events, all ranks; gated:
   every rank's launch queued before the first starts) and per launch
   (traced) beside its bounds; K1 raw and K7 (the fused block with the banded ring)
   at the halo shards of the 40x40 flag (4 ranks of 2,560 edges, chunks
   dealt round-robin) in bf16 and float32: K1 raw against its plain
   version on every rank's shard (timed in the K1 checks above), K7's e2
   bit for bit with K1's and its aggregate against K1 raw + the plain
   all-reduce + finalize, timed as K6;
4. serving: ``Predictor.from_config`` on configs/flag_full_scale.yaml with
   RMP off (latent 128, 15 blocks, bf16, ``agg_vjp: fused``, then
   ``agg_vjp: sorted``, then ``fused`` with ``graph_balancer.algorithm:
   ricci``), seeded random weights, normalizers accumulated over a 40x40
   synthetic flag trajectory (1,600 nodes, 9,282 edges); ``one_step`` on 21
   frames and a 50-step ``rollout``, with every kernel's launch count read
   around that run (15 K1, or 15 K4f, per forward; with the balancer 2 K5
   per SDRF loop of each call's prepare); the card's ``one_step`` held
   against the same state (and the same balancer static) on the CPU;
   then the halo forward (``parallel.halo.make_halo_forward``) of the same
   configuration over 4 ranks on the card, one frame per call, for
   ``agg_vjp: fused`` (K1 raw + the plain all-reduce), ``xla`` with the ring
   (K6) and ``fused`` with overlap (K7): the launch counts of one forward
   (15 per rank), every rank against the single-device forward on the card
   and against the CPU, ms per forward (50 calls) beside the single-device
   forward;
5. training: ``Trainer.train_step`` on the same configuration, B = 21, Adam
   at lr 1e-4, noise 0.003, gamma 0.9, with ``fused_bwd: remat``, then
   ``stream``, then ``agg_vjp: sorted``, then remat with the balancer; the
   launch counts read around one step of each (15 K1 and 15 K2, 15 K1 and
   15 K3, or 15 K4f and 15 K4b; with the balancer also the trainer's
   prepare: 2 K5 per SDRF loop); the card's loss and gradients held against
   the same state, noise and static on the CPU (B = 2, bf16 and float32);
   the loss after 30 steps on one batch below the first step's (remat,
   sorted, balancer); train-step ms (median of 10 after 3 warm-up steps)
   and edges/s;
6. timings, each with the card (with --profile also the device's busy share
   and kernel time by name), the kernels' JSON line, then the device JSON
   line last.

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
# aggregate sums a handful of such elements.  K1's LayerNorm statistics are
# float32 sums of z3, whose elements may differ by one such unit.
TOL = {
    "float32": {"e2": (1e-5, 1e-5), "agg": (1e-5, 1e-5), "stats": (1e-5, 1e-5)},
    "bfloat16": {"e2": (2.0**-7, 2.0**-5), "agg": (2.0**-5, 2.0**-5), "stats": (2.0**-6, 2.0**-6)},
}

# K2/K3 against their plain versions, both on K1's forward values (relu
# masks and tie compare), per output: |err| <= rtol*|want| + atol*max|want|.
# float32: summation order.  bf16: a product summed in another order rounds
# the other way by one unit in the last place (2**-7 of the element), and
# the LayerNorm and MLP backward pass such differences on, scaled by the
# weights; the column sums (dpar) by relative L2 norm per row.
BWD_TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (2.0**-6, 2.0**-6, 2.0**-5)}

# one_step on the card against the CPU (both bf16, 15 blocks): network
# outputs within 5% of the largest |output|, accelerations within 1% of the
# largest |acceleration|.
SERVE_TOL = {"net_out": 0.05, "acceleration": 0.01}

# A train step's loss and gradients on the card against the CPU, same state
# and noise, B = 2, 15 blocks.  float32: summation order (a relu whose input
# lies within one rounding of 0 may flip, a handful of elements in
# millions): loss rtol 1e-4, each gradient within relative L2 1e-3.  bf16:
# single elements round the other way and such differences pass through 15
# blocks and their backward: loss within 2**-5, each gradient within
# relative L2 2**-4.  (Measured on an H100: float32 1.7e-4 and bf16 1.3e-2
# for the worst gradient.)
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2.0**-5, 2.0**-4)}
# bf16 only: the gradients of the balancer's ``balance`` edge models, summed
# over B x 298 valid balance edges where a mesh-edge tensor sums over
# B x 9,282.  A relu input within one bf16 rounding of 0 flips between the
# card and the CPU and moves its row's whole contribution, about
# 1/sqrt(600) = 4% of such a per-tensor norm each (measured on an H100: 0.186
# for one bias); a missing or misrouted gradient gives 1 or more.  In float32
# they are held to TRAIN_TOL with every other tensor.
BALANCE_BF16_GRAD_TOL = 0.5

# K4f against its plain version (which sums with atomics on the card, in
# another order): sum and mean within rtol + 1e-5 absolute, float32 rtol
# 1e-5, bf16 one unit in the last place (2**-7) where the float32 sums round
# to neighbouring bf16 values; max and min exactly equal.  K4b against its
# plain version on K4f's output: bit for bit (the same float32 steps, an
# exact tie compare).
SORTED_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}

ONE_STEP_FRAMES = 21  # the batch bench.py trains on
ROLLOUT_STEPS = 50
TRAIN_FRAMES = 21
CPU_FRAMES = 2  # card against CPU
LOSS_STEPS = 30
WARMUP_STEPS = 3
TIMED_STEPS = 10
L_MAIN = 128
TRACE_ATTEMPTS = 3
BWD_KERNELS = ("fused_block_bwd_kernel", "sender_sum_kernel", "dpar_reduce_kernel")


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
    """(name, microseconds) of every kernel a torch.profiler run recorded;
    user annotations (an optimizer step's range on the device's timeline)
    are not kernels."""
    import torch

    return [
        (ev.name, ev.time_range.elapsed_us())
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False)
    ]


def kernel_device_ms(fn, iters: int, names) -> float:
    """Device time per call of ``fn`` spent in the kernels whose names
    contain one of ``names`` (each launched once per call), traced over
    ``iters`` calls after a warm-up: the kernels' own time, without the
    host's launch cost (which bounds a small launch timed back to back with
    CUDA events).

    On the H100's machine a trace may come back with only some of the
    window's kernel records (0 to 19 of 20 seen), whatever the kernel: each
    kernel's time is then the mean over the launches the trace did record.
    A window in which some kernel has no record is traced again, up to
    TRACE_ATTEMPTS times, and then the call fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (names,) if isinstance(names, str) else tuple(names)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        times = {n: [us for kname, us in kernels if n in kname] for n in names}
        if any(len(t) != iters for t in times.values()):
            log(f"trace {attempt} of {TRACE_ATTEMPTS}: {({n: len(t) for n, t in times.items()})} "
                f"launches recorded of {iters} each")
        if all(times.values()):
            return sum(sum(t) / len(t) for t in times.values()) / 1e3
    raise RuntimeError(f"no trace of {names} recorded every kernel in {TRACE_ATTEMPTS} attempts")


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


def _bound(bytes_moved, flops, dtype_name, peaks) -> tuple:
    _, bw, bf16_peak, f32_peak = peaks
    t_bytes = bytes_moved / bw * 1e3
    t_ops = flops / (bf16_peak if dtype_name == "bfloat16" else f32_peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound_ms(dtype_name, B, E, N, L, peaks, streams=False) -> tuple:
    """Least time for one K1 call: each input read once and each output
    written once, or the three L x L products at the peak rate."""
    s = 2 if dtype_name == "bfloat16" else 4
    bytes_moved = (
        B * E * L * s * 2  # e in, e2 out
        + B * N * L * s * 2  # SP, RP in
        + B * N * 4 * L * 4  # agg out (float32)
        + E * 4 * 2 + (N + 1) * 4  # senders, receivers, row_ptr
        + 3 * L * L * s + 5 * L * 4  # weights, biases, LayerNorm
        + (B * E * L * s * 2 + B * E * 4 * 2 if streams else 0)  # a1, a2, mu, isg out
    )
    return _bound(bytes_moved, 3 * 2 * B * E * L * L, dtype_name, peaks)


def bwd_bound_ms(dtype_name, B, E, N, L, peaks, stream) -> tuple:
    """Least time for one K2 (``stream`` False) or K3 call: e, de2 and drhs
    in, with SP and RP (K2) or a1, a2, mu, isg (K3); de, dh, dz2, dz3 (and,
    K2, a1, a2) out, with dsp, drp and the column sums; six (K2) or four (K3)
    L x L products."""
    s = 2 if dtype_name == "bfloat16" else 4
    edge = B * E * L * s
    bytes_moved = (
        2 * edge  # e, de2 in
        + (2 * edge + 2 * B * E * 4 if stream else 2 * B * N * L * s)  # streams or SP, RP
        + B * N * 5 * L * 4  # drhs in
        + (4 if stream else 6) * edge  # edge streams out
        + 2 * B * N * L * 4 + 5 * L * 4  # dsp, drp, dpar out
        + E * 4 * 3 + (N + 1) * 4 * 2  # senders, receivers, sender order, row_ptr, snd_ptr
        + 3 * L * L * s + 5 * L * 4  # weights, biases, LayerNorm
    )
    flops = (4 if stream else 6) * 2 * B * E * L * L
    return _bound(bytes_moved, flops, dtype_name, peaks)


def check_close(name, got, want, rtol, atol):
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max())}"
        )
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: not finite")
    return float(err.max())


def rel_l2(got, want) -> float:
    d = float((got.float() - want.float()).norm())
    return d / max(float(want.float().norm()), 1e-30)


def phase_kernels(card, peaks, topo_np, seed):
    """K1 (with and without its streams) against its plain version at the
    main path's shapes."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.ops.fused_block import (
        fused_edge_block,
        fused_edge_block_fwd,
        fused_edge_block_reference,
        plan_segments,
    )

    snd, rcv, N = topo_np
    L, E = L_MAIN, len(snd)
    gen = torch.Generator().manual_seed(seed)
    results = {}
    cases = [("bfloat16", ONE_STEP_FRAMES), ("float32", ONE_STEP_FRAMES), ("bfloat16", 1)]
    for dtype_name, B in cases:
        dtype = getattr(torch, dtype_name)
        x = k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda")
        plan = plan_segments(rcv, N, senders=snd).to("cuda")
        run = lambda: fused_edge_block(**x, plan=plan)
        e2, agg = run()
        torch.cuda.synchronize()
        re2, ragg = fused_edge_block_reference(**x)
        rt, at = TOL[dtype_name]["e2"]
        err = check_close(f"K1 {dtype_name} B={B} e2", e2, re2, rt, at)
        rt, at = TOL[dtype_name]["agg"]
        err = max(err, check_close(f"K1 {dtype_name} B={B} agg", agg, ragg, rt, at))
        ms = kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
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

    # raw mode on one rank's edge shard of the halo forward: 2,560 edges of
    # the 40x40 flag padded and dealt round-robin by chunks (the overlap
    # layout), and rank 0's 2,321 contiguous edges (the fused path's)
    shard = overlap_shards(torch.bfloat16, gen)[0][0]
    per = -(-E // HALO_RANKS)
    x1 = k1_inputs(torch.bfloat16, 1, snd[:per], rcv[:per], N, L, gen, "cuda")
    raw_cases = [
        ("raw shard", (shard["e"][None], shard["sp"][None], shard["rp"][None], shard["weights"],
                       shard["senders"], shard["receivers"], shard["mask"], N), shard["plan"]),
        ("raw contiguous shard", (x1["e"], x1["sp"], x1["rp"], x1["weights"], x1["senders"],
                                  x1["receivers"], None, N),
         plan_segments(rcv[:per], N, senders=snd[:per]).to("cuda")),
    ]
    for tag, raw_args, raw_plan in raw_cases:
        E_raw = raw_args[0].shape[1]
        run = lambda: fused_edge_block_fwd(*raw_args, plan=raw_plan, raw=True)
        e2, raw = run()
        torch.cuda.synchronize()
        re2, rraw = fused_edge_block_reference(*raw_args, raw=True)
        err = max(check_close(f"K1 {tag} e2", e2, re2, *TOL["bfloat16"]["e2"]),
                  check_close(f"K1 {tag} agg", raw, rraw, *TOL["bfloat16"]["agg"]))
        ms = kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
        plain_ms = cuda_time_ms(lambda: fused_edge_block_reference(*raw_args, raw=True), iters=10)
        bound, bound_by = k1_bound_ms("bfloat16", 1, E_raw, N, L, peaks)
        results[("bfloat16 " + tag, 1)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
        )
        log(
            f"K1 {tag} bfloat16 E={E_raw} N={N} L={L}: kernel {ms * 1e3:.1f} us, bound "
            f"{bound * 1e3:.2f} us ({bound_by}), plain {plain_ms:.3f} ms, max abs err {err:.3g} [{card}]"
        )

    # with the streams K3 reads (save_streams), at the main path's shapes
    for dtype_name in ("bfloat16", "float32"):
        dtype, B = getattr(torch, dtype_name), ONE_STEP_FRAMES
        x = k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda")
        plan = plan_segments(rcv, N, senders=snd).to("cuda")
        args = (x["e"], x["sp"], x["rp"], x["weights"], x["senders"], x["receivers"], None, N)
        run = lambda: fused_edge_block_fwd(*args, plan=plan, save_streams=True)
        got = run()
        torch.cuda.synchronize()
        want = fused_edge_block_reference(*args, save_streams=True)
        err = 0.0
        for name, g, w, tol in zip(
            ("e2", "agg", "a1", "a2", "mu", "isg"), got, want,
            ("e2", "agg", "e2", "e2", "stats", "stats"),
        ):
            err = max(err, check_close(f"K1 streams {dtype_name} {name}", g, w, *TOL[dtype_name][tol]))
        ms = kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
        plain_ms = cuda_time_ms(lambda: fused_edge_block_reference(*args, save_streams=True), iters=10)
        bound, bound_by = k1_bound_ms(dtype_name, B, E, N, L, peaks, streams=True)
        results[(dtype_name + " streams", B)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
        )
        log(
            f"K1+streams {dtype_name} B={B}: kernel {ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
            f"({bound_by}), plain {plain_ms:.3f} ms, max abs err {err:.3g} [{card}]"
        )

    # masked tail and an isolated receiver, bf16, at the main path's width
    snd_m, rcv_m, mask = masked_topology(snd, rcv, N)
    x = k1_inputs(torch.bfloat16, 3, snd_m, rcv_m, N, L, gen, "cuda", mask=mask)
    e2, agg = fused_edge_block(**x)
    re2, ragg = fused_edge_block_reference(**x)
    check_close("K1 masked e2", e2, re2, *TOL["bfloat16"]["e2"])
    check_close("K1 masked agg", agg, ragg, *TOL["bfloat16"]["agg"])
    if not bool((agg[:, 10] == 0).all()):
        raise AssertionError("K1: isolated receiver's aggregate is not 0")
    log("K1 masked tail + isolated receiver: ok")

    # masked edges inside segments, spread through the mesh (the balancer's
    # removals), and receiver 10 with all its edges masked
    mask_i = interior_mask(rcv)
    x = k1_inputs(torch.bfloat16, 3, snd, rcv, N, L, gen, "cuda", mask=mask_i)
    e2, agg = fused_edge_block(**x, plan=plan_segments(rcv, N, senders=snd).to("cuda"))
    re2, ragg = fused_edge_block_reference(**x)
    check_close("K1 interior mask e2", e2, re2, *TOL["bfloat16"]["e2"])
    check_close("K1 interior mask agg", agg, ragg, *TOL["bfloat16"]["agg"])
    if not bool((agg[:, 10] == 0).all()):
        raise AssertionError("K1 interior mask: receiver 10's aggregate is not 0")
    log(f"K1 interior mask ({int((mask_i == 0).sum())} of {len(mask_i)} edges masked inside segments): ok")
    return results


def interior_mask(rcv):
    """Every seventh edge from the fourth masked, inside receivers' segments
    as the graph balancer's removals are, and receiver 10 with all its edges
    masked."""
    import numpy as np

    mask = np.ones(len(rcv), np.float32)
    mask[3::7] = 0.0
    mask[rcv == 10] = 0.0
    return mask


def masked_topology(snd, rcv, N, pad=5):
    """Receiver 10 loses its edges; ``pad`` masked edges are appended."""
    import numpy as np

    keep = rcv != 10
    snd_m = np.concatenate([snd[keep], np.zeros(pad, np.int32)])
    rcv_m = np.concatenate([rcv[keep], np.full(pad, N - 1, np.int32)])
    mask = np.r_[np.ones(int(keep.sum())), np.zeros(pad)].astype(np.float32)
    return snd_m, rcv_m, mask


def tie_topology(snd, rcv, N):
    """Every third receiver's first edge twice (the copy next to it), and
    the positions of the copies: their rows must also be copied in ``e``."""
    import numpy as np

    dup = np.asarray([np.flatnonzero(rcv == n)[0] for n in range(0, N, 3) if np.any(rcv == n)])
    order = np.sort(np.concatenate([np.arange(len(snd)), dup]))
    copies = np.flatnonzero(np.diff(order) == 0) + 1
    return snd[order], rcv[order], order, copies


def phase_backward(card, peaks, topo_np, seed):
    """K2 and K3 against their plain versions, the routed max/min mass, and
    the weight-gradient products of one block."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.ops.fused_block import (
        agg_cotangent_rhs,
        fused_edge_block_bwd,
        fused_edge_block_bwd_reference,
        fused_edge_block_bwd_stream,
        fused_edge_block_bwd_stream_reference,
        fused_edge_block_fwd,
        plan_segments,
    )

    snd, rcv, N = topo_np
    L = L_MAIN
    gen = torch.Generator().manual_seed(seed + 1)

    def setup(dtype_name, B, snd, rcv, mask=None, rows=None, route_only=False):
        dtype = getattr(torch, dtype_name)
        x = k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda", mask)
        if rows is not None:  # copied edges get their original's features
            x["e"] = x["e"][:, torch.as_tensor(rows).cuda()].contiguous()
        E = len(snd)
        plan = plan_segments(rcv, N, senders=snd).to("cuda")
        topo = (x["senders"], x["receivers"], x["mask"], N)
        fwd = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *topo, plan=plan, save_streams=True)
        if route_only:  # only g_max = g_min = 1
            de2 = torch.zeros(B, E, L, dtype=dtype, device="cuda")
            dagg = torch.zeros(B, N, 4 * L, device="cuda")
            dagg[..., 2 * L :] = 1.0
        else:
            de2 = torch.randn(B, E, L, generator=gen).to(dtype).cuda()
            if mask is not None:
                de2 = de2 * x["mask"][:, None].to(dtype)  # masked rows' cotangent is dead
            dagg = torch.randn(B, N, 4 * L, generator=gen).cuda()
        drhs = agg_cotangent_rhs(fwd[1], dagg, x["receivers"], x["mask"], N)
        return x, topo, plan, fwd, de2, drhs

    def kernels(x, topo, plan, fwd, de2, drhs):
        e2, agg, a1, a2, mu, isg = fwd
        k2 = lambda: fused_edge_block_bwd(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo, plan=plan)
        k3 = lambda: fused_edge_block_bwd_stream(
            x["e"], a1, a2, mu, isg, x["weights"], de2, drhs, *topo, plan=plan
        )
        return k2, k3

    def compare(tag, dtype_name, got, want):
        """de, dh, dz2, dz3, dsp, drp elementwise; dpar rows by relative L2."""
        rtol, atol, l2 = BWD_TOL[dtype_name]
        err = 0.0
        for name, g, w in zip(("de", "dh", "dz2", "dz3", "dsp", "drp"), got[:6], want[:6]):
            e = check_close(f"{tag} {name}", g, w, rtol, atol * float(w.float().abs().max()))
            if name in ("de", "dh", "dz2", "dz3"):
                err = max(err, e)
        for k in range(5):
            r = rel_l2(got[6][k], want[6][k])
            if not r <= l2:
                raise AssertionError(f"{tag} dpar row {k}: relative L2 {r:.3g} > {l2}")
        return err

    def check_both(tag, dtype_name, x, topo, plan, fwd, de2, drhs):
        e2, agg, a1, a2, mu, isg = fwd
        k2, k3 = kernels(x, topo, plan, fwd, de2, drhs)
        out2, out3 = k2(), k3()
        torch.cuda.synchronize()
        # K2 recomputes K1's forward bit for bit
        if not (torch.equal(out2[4], a1) and torch.equal(out2[5], a2)):
            raise AssertionError(f"{tag}: K2's recomputed a1/a2 differ from K1's")
        w = x["weights"]
        ref2 = fused_edge_block_bwd_reference(
            x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2)
        )
        ref3 = fused_edge_block_bwd_stream_reference(x["e"], a1, a2, mu, isg, w, de2, drhs, *topo, e2=e2)
        err2 = compare(f"K2 {tag}", dtype_name, out2[:4] + out2[6:], ref2[:4] + ref2[6:])
        err3 = compare(f"K3 {tag}", dtype_name, out3, ref3)
        return err2, err3, k2, k3, out2, out3

    results = {}
    for dtype_name in ("bfloat16", "float32"):
        B = TRAIN_FRAMES
        E = len(snd)
        x, topo, plan, fwd, de2, drhs = setup(dtype_name, B, snd, rcv)
        err2, err3, k2, k3, out2, _ = check_both(f"{dtype_name} B={B}", dtype_name, x, topo, plan, fwd, de2, drhs)
        e2, agg, a1, a2, mu, isg = fwd
        w = x["weights"]
        plain2 = lambda: fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo)
        plain3 = lambda: fused_edge_block_bwd_stream_reference(x["e"], a1, a2, mu, isg, w, de2, drhs, *topo)
        for name, fn, plain, err, stream in (("K2", k2, plain2, err2, False), ("K3", k3, plain3, err3, True)):
            ms = kernel_device_ms(fn, iters=10, names=BWD_KERNELS)
            main_ms, sender_ms, reduce_ms = (kernel_device_ms(fn, iters=10, names=n) for n in BWD_KERNELS)
            call_ms = cuda_time_ms(fn, iters=20)
            plain_ms = cuda_time_ms(plain, iters=5)
            bound, bound_by = bwd_bound_ms(dtype_name, B, E, N, L, peaks, stream)
            results[(name, dtype_name)] = dict(
                max_abs_err=err, ms=ms, main_kernel_ms=main_ms, sender_sum_ms=sender_ms,
                dpar_reduce_ms=reduce_ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by,
            )
            log(
                f"{name} {dtype_name} B={B} E={E} N={N} L={L}: kernels {ms * 1e3:.1f} us "
                f"(main kernel {main_ms * 1e3:.1f}, sender sums {sender_ms * 1e3:.1f}, column-sum "
                f"reduction {reduce_ms * 1e3:.1f} us; wrapper call {call_ms * 1e3:.1f} us), "
                f"bound {bound * 1e3:.2f} us ({bound_by}), plain {plain_ms:.3f} ms, "
                f"max abs err {err:.3g} [{card}]"
            )
        # the weight gradients of one block (FusedEdgeBlock.backward)
        de, dh, dz2, dz3 = out2[:4]
        flat = lambda t: t.reshape(-1, L).float()
        wgrad = lambda: (flat(dh).T @ flat(x["e"]), flat(dz2).T @ flat(a1), flat(dz3).T @ flat(a2))
        wg_ms = cuda_time_ms(wgrad, iters=10)
        wg_bound, wg_by = _bound(
            3 * (2 * B * E * L * (2 if dtype_name == "bfloat16" else 4) + L * L * 4),
            3 * 2 * B * E * L * L, "float32", peaks,
        )
        results[("wgrad", dtype_name)] = dict(ms=wg_ms, bound_ms=wg_bound, bound_by=wg_by)
        log(
            f"weight-gradient products (3 float32 L x L over B*E={B * E} rows) {dtype_name}: "
            f"{wg_ms:.3f} ms per block, bound {wg_bound:.3f} ms ({wg_by}) [{card}]"
        )

    # masked tail + isolated receiver, and exactly tied edges; bf16, B = 3
    snd_m, rcv_m, mask = masked_topology(snd, rcv, N)
    x, topo, plan, fwd, de2, drhs = setup("bfloat16", 3, snd_m, rcv_m, mask=mask)
    *_, out2, out3 = check_both("masked", "bfloat16", x, topo, plan, fwd, de2, drhs)
    for name, drp in (("K2", out2[7]), ("K3", out3[5])):
        if not bool((drp[:, 10] == 0).all()):
            raise AssertionError(f"{name}: isolated receiver's drp is not 0")
    log("K2/K3 masked tail + isolated receiver: ok")
    x, topo, plan, fwd, de2, drhs = setup("bfloat16", 3, snd, rcv, mask=interior_mask(rcv))
    *_, out2, out3 = check_both("interior mask", "bfloat16", x, topo, plan, fwd, de2, drhs)
    for name, drp in (("K2", out2[7]), ("K3", out3[5])):
        if not bool((drp[:, 10] == 0).all()):
            raise AssertionError(f"{name} interior mask: receiver 10's drp is not 0")
    log("K2/K3 interior mask: ok")
    snd_t, rcv_t, rows, copies = tie_topology(snd, rcv, N)
    copies = torch.as_tensor(copies).cuda()
    x, topo, plan, fwd, de2, drhs = setup("bfloat16", 3, snd_t, rcv_t, rows=rows)
    check_both("ties", "bfloat16", x, topo, plan, fwd, de2, drhs)
    log("K2/K3 tied edges: ok")
    # one frame: about 150 work items for two teams a CTA on ceil(150 / 2) CTAs
    x, topo, plan, fwd, de2, drhs = setup("bfloat16", 1, snd, rcv)
    check_both("B=1", "bfloat16", x, topo, plan, fwd, de2, drhs)
    log("K2/K3 B=1: ok")

    # routed mass: with only g_max = g_min = 1 the column sums of do (dpar
    # row 4) count the edges equal to their receiver's extremum in K1's own
    # output, exactly; every receiver with valid edges routes at least once
    masses = {}
    for tag, args in (
        ("main", (snd, rcv)), ("masked", (snd_m, rcv_m)), ("ties", (snd_t, rcv_t)),
    ):
        B = TRAIN_FRAMES if tag == "main" else 3
        kw = dict(mask=mask) if tag == "masked" else dict(rows=rows) if tag == "ties" else {}
        x, topo, plan, fwd, de2, drhs = setup("bfloat16", B, *args, route_only=True, **kw)
        e2, agg = fwd[:2]
        r = x["receivers"].long()
        valid = torch.ones_like(r, dtype=torch.bool) if x["mask"] is None else x["mask"] > 0
        want = sum(
            ((e2.float() == agg[:, r, k * L : (k + 1) * L]) & valid[None, :, None]).float().sum(dim=(0, 1))
            for k in (2, 3)
        )
        receivers = B * int(torch.unique(r[valid]).numel())
        k2, k3 = kernels(x, topo, plan, fwd, de2, drhs)
        for name, fn in (("K2", k2), ("K3", k3)):
            out = fn()
            mass = out[-1][4]
            if tag == "ties" and not torch.equal(out[0][:, copies], out[0][:, copies - 1]):
                raise AssertionError(f"{name}: the two copies of a tied edge got different cotangents")
            if not torch.equal(mass, want):
                raise AssertionError(
                    f"{name} routed mass ({tag}) differs from the tie count of K1's output in "
                    f"{int((mass != want).sum())} columns"
                )
        if not bool((want >= 2 * receivers).all()):
            raise AssertionError(f"routed mass ({tag}): a receiver routed nothing")
        masses[tag] = (float(want.min()), 2 * receivers)
        log(f"routed max+min mass ({tag}): min over columns {float(want.min()):.0f} >= {2 * receivers} "
            f"(2 x receivers with valid edges), equal to K1's tie count for K2 and K3")
    results["routed_mass"] = masses
    return results


def sorted_bound_ms(dtype_name, B, E, N, L, peaks, backward) -> tuple:
    """Least time for one K4f call (edges in, [B, N, 4L] out) or K4b call
    (edges, the node cotangent and the saved max/min in, edge cotangent
    out), each in the data's dtype, with row_ptr (no mask: the timed calls
    pass none); about 4 and 6 operations per edge element, float32 outside
    the tensor cores."""
    s = 2 if dtype_name == "bfloat16" else 4
    edge, node = B * E * L * s, B * N * L * s
    bytes_moved = (N + 1) * 4
    bytes_moved += (edge + 4 * node + 2 * node + edge) if backward else (edge + 4 * node)
    flops = (6 if backward else 4) * B * E * L
    return _bound(bytes_moved, flops, "float32", peaks)


def phase_sorted(card, peaks, topo_np, seed):
    """K4f and K4b against their plain versions, timed, with a masked tail,
    tied edges and the routed max/min mass."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.segment_pna import (
        pna_sorted,
        pna_sorted_bwd,
        pna_sorted_bwd_reference,
        pna_sorted_reference,
        sorted_plan,
    )

    snd, rcv, N = topo_np
    L = L_MAIN
    gen = torch.Generator().manual_seed(seed + 2)

    def setup(dtype_name, B, rcv, mask=None, rows=None):
        dtype = getattr(torch, dtype_name)
        E = len(rcv)
        data = torch.randn(B, E, L, generator=gen)
        if rows is not None:  # copied edges get their original's features
            data = data[:, torch.as_tensor(rows)]
        data = data.to(dtype).cuda().contiguous()
        r = torch.as_tensor(rcv).cuda()
        m = None if mask is None else torch.as_tensor(mask).cuda()
        plan = sorted_plan(rcv, N, mask).to("cuda")
        return data, r, m, plan

    def check(tag, dtype_name, data, r, m, plan, g=None):
        """K4f and K4b once each against their plain versions; returns the
        outputs and the largest error of K4f's sum and mean."""
        out = pna_sorted(data, r, m, N, plan=plan)
        if g is None:
            g = torch.randn(out.shape, generator=gen).to(data.dtype).cuda()
        ge = pna_sorted_bwd(g, out, data, r, m, N, plan=plan)
        torch.cuda.synchronize()
        want = pna_sorted_reference(data, r, m, N)
        rt = SORTED_TOL[dtype_name]
        err = check_close(f"K4f {tag} sum/mean", out[..., : 2 * L], want[..., : 2 * L], rt, 1e-5)
        if not torch.equal(out[..., 2 * L :], want[..., 2 * L :]):
            raise AssertionError(f"K4f {tag}: max/min differ from the plain version")
        if not torch.equal(ge, pna_sorted_bwd_reference(g, out, data, r, m, N)):
            raise AssertionError(f"K4b {tag}: differs from the plain version on K4f's output")
        if not bool(torch.isfinite(ge.float()).all()):
            raise AssertionError(f"K4b {tag}: not finite")
        return out, g, ge, err

    results = {}
    for dtype_name, B in (("bfloat16", TRAIN_FRAMES), ("float32", TRAIN_FRAMES), ("bfloat16", 1)):
        E = len(rcv)
        data, r, m, plan = setup(dtype_name, B, rcv)
        out, g, ge, err = check(f"{dtype_name} B={B}", dtype_name, data, r, m, plan)
        fwd = lambda: pna_sorted(data, r, None, N, plan=plan)
        bwd = lambda: pna_sorted_bwd(g, out, data, r, None, N, plan=plan)
        lengths = (plan.row_ptr[1:] - plan.row_ptr[:-1]).expand(B, N).contiguous()
        library = lambda: [
            torch.segment_reduce(data, op, lengths=lengths, axis=1) for op in ("sum", "mean", "max", "min")
        ]
        for name, run, plain, kname, backward in (
            ("K4f", fwd, lambda: pna_sorted_reference(data, r, None, N), "pna_fwd_kernel", False),
            ("K4b", bwd, lambda: pna_sorted_bwd_reference(g, out, data, r, None, N), "pna_bwd_kernel", True),
        ):
            ms = kernel_device_ms(run, iters=20, names=kname)
            call_ms = cuda_time_ms(run, iters=50)
            plain_ms = cuda_time_ms(plain, iters=10)
            bound, bound_by = sorted_bound_ms(dtype_name, B, E, N, L, peaks, backward)
            res = dict(
                max_abs_err=err if name == "K4f" else 0.0, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            )
            if name == "K4f":
                res["segment_reduce_x4_ms"] = cuda_time_ms(library, iters=10)
            results[(name, dtype_name, B)] = res
            extra = f", 4 segment_reduce {res['segment_reduce_x4_ms']:.3f} ms" if name == "K4f" else ""
            log(
                f"{name} {dtype_name} B={B} E={E} N={N} L={L}: kernel {ms * 1e3:.1f} us "
                f"(wrapper call {call_ms * 1e3:.1f} us), bound {bound * 1e3:.2f} us ({bound_by}), "
                f"plain {plain_ms:.3f} ms{extra}, max abs err {res['max_abs_err']:.3g} [{card}]"
            )

    # masked tail and an isolated receiver, and exactly tied edges; bf16, B = 3
    snd_m, rcv_m, mask = masked_topology(snd, rcv, N)
    data, r, m, plan = setup("bfloat16", 3, rcv_m, mask=mask)
    out, _, ge, _ = check("masked", "bfloat16", data, r, m, plan)
    if not (bool((out[:, 10] == 0).all()) and bool((ge[:, m == 0] == 0).all())):
        raise AssertionError("K4f/K4b: isolated receiver or masked edges not 0")
    log("K4f/K4b masked tail + isolated receiver: ok")
    mask_i = interior_mask(rcv)
    data_i, r_i, m_i, _ = setup("bfloat16", 3, rcv, mask=mask_i)
    plan_i = sorted_plan(rcv, N).to("cuda")  # built without the mask, as build_topology does
    out, _, ge, _ = check("interior mask", "bfloat16", data_i, r_i, m_i, plan_i)
    if not (bool((out[:, 10] == 0).all()) and bool((ge[:, m_i == 0] == 0).all())):
        raise AssertionError("K4f/K4b interior mask: receiver 10 or masked edges not 0")
    log("K4f/K4b interior mask: ok")
    snd_t, rcv_t, rows, copies = tie_topology(snd, rcv, N)
    copies = torch.as_tensor(copies).cuda()
    data_t, r_t, _, plan_t = setup("bfloat16", 3, rcv_t, rows=rows)
    _, _, ge, _ = check("ties", "bfloat16", data_t, r_t, None, plan_t)
    if not torch.equal(ge[:, copies], ge[:, copies - 1]):
        raise AssertionError("K4b: the two copies of a tied edge got different cotangents")
    log("K4f/K4b tied edges: ok")

    # routed mass: with only g_max = g_min = 1 the column sums of the edge
    # cotangent count the edges equal to their receiver's extremum in K4f's
    # own output, exactly; every receiver with valid edges routes at least once
    masses = {}
    data_main, r_main, _, plan_main = setup("bfloat16", TRAIN_FRAMES, rcv)
    for tag, (d, rr, mm, pl) in (
        ("main", (data_main, r_main, None, plan_main)), ("masked", (data, r, m, plan)),
        ("ties", (data_t, r_t, None, plan_t)), ("interior", (data_i, r_i, m_i, plan_i)),
    ):
        out = pna_sorted(d, rr, mm, N, plan=pl)
        g = torch.zeros_like(out)
        g[..., 2 * L :] = 1.0
        _, _, ge, _ = check(f"routed mass {tag}", "bfloat16", d, rr, mm, pl, g=g)
        valid = torch.ones_like(rr, dtype=torch.bool) if mm is None else mm > 0
        want = sum(
            ((d.float() == out.float()[:, rr.long(), k * L : (k + 1) * L]) & valid[None, :, None])
            .float().sum(dim=(0, 1))
            for k in (2, 3)
        )
        mass = ge.float().sum(dim=(0, 1))
        receivers = d.shape[0] * int(torch.unique(rr[valid]).numel())
        if not torch.equal(mass, want):
            raise AssertionError(
                f"K4b routed mass ({tag}) differs from the tie count of K4f's output in "
                f"{int((mass != want).sum())} columns"
            )
        if not bool((want >= 2 * receivers).all()):
            raise AssertionError(f"K4b routed mass ({tag}): a receiver routed nothing")
        masses[tag] = (float(want.min()), 2 * receivers)
        log(f"K4b routed max+min mass ({tag}): min over columns {float(want.min()):.0f} >= "
            f"{2 * receivers} (2 x receivers with valid edges), equal to K4f's tie count")
    results["routed_mass"] = masses
    return results


def maxprod_bound_ms(N, K, M, peaks) -> tuple:
    """Least time for one K5 call: x and y read once and out written once
    (float32), or its N*K*M multiplies and maxes at the float32 instruction
    rate, half the published float32 FLOP/s (which count a fused
    multiply-add as two operations): 4*N*K*M "FLOP" at that peak."""
    return _bound((N * K + K * M + N * M) * 4, 4 * N * K * M, "float32", peaks)


def flag_adjacency(topo_np):
    """The 0/1 adjacency ``A`` of the mesh and ``B = relu(A @ A - A)``: the
    operands of the curvature's two K5 calls."""
    import torch

    snd, rcv, N = topo_np
    A = torch.zeros(N, N, device="cuda")
    A[torch.as_tensor(snd).long(), torch.as_tensor(rcv).long()] = 1.0
    return A, torch.clamp(A @ A - A, min=0.0)


def phase_maxprod(card, peaks, topo_np, seed):
    """K5 against its plain version, bit for bit: the 40x40 flag's curvature
    operands in both orders, random non-negative inputs at 1,600 cubed, and
    odd shapes; timed at the flag's shapes."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference

    gen = torch.Generator().manual_seed(seed + 3)
    rand = lambda *s: (torch.rand(*s, generator=gen) * (torch.rand(*s, generator=gen) > 0.5)).cuda()
    A, B = flag_adjacency(topo_np)
    cases = {
        "flag B x A": (B, A), "flag A x B": (A, B),
        "random 1600^3": (rand(1600, 1600), rand(1600, 1600)),
        "odd 1000x1300x700": (rand(1000, 1300), rand(1300, 700)),
        "odd 37x5x129": (rand(37, 5), rand(5, 129)),
    }
    results = {}
    for tag, (x, y) in cases.items():
        got = maxprod(x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, maxprod_reference(x, y)):
            raise AssertionError(f"K5 {tag}: differs from the plain version")
        log(f"K5 {tag}: equal to the plain version bit for bit")
    for tag in ("flag B x A", "random 1600^3"):
        x, y = cases[tag]
        N, K = x.shape
        M = y.shape[1]
        run = lambda: maxprod(x, y)
        ms = kernel_device_ms(run, iters=20, names="maxprod_kernel")
        call_ms = cuda_time_ms(run, iters=20)
        plain_ms = cuda_time_ms(lambda: maxprod_reference(x, y), iters=3, warmup=1)
        bound, bound_by = maxprod_bound_ms(N, K, M, peaks)
        results[tag] = dict(
            max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
        )
        log(
            f"K5 {tag} N={N} K={K} M={M}: kernel {ms * 1e3:.1f} us (wrapper call {call_ms * 1e3:.1f} us), "
            f"bound {bound * 1e3:.1f} us ({bound_by}), plain {plain_ms:.3f} ms, max abs err 0 [{card}]"
        )
    return results


def phase_sdrf(card, topo_np):
    """SDRF on the 40x40 flag with the configuration's settings (150 loops,
    tau 150, removal), once through K5 and once through its plain version on
    the card: the same added and removed edges."""
    import torch

    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference

    snd, rcv, N = topo_np
    kw = dict(loops=150, remove_edges=True, tau=150, device="cuda")
    runs = {}
    for name, fn in (("K5", maxprod), ("plain", maxprod_reference)):
        before = maxprod.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lists = sdrf(snd, rcv, N, maxprod_fn=fn, **kw)
        seconds = time.perf_counter() - t0
        runs[name] = (lists, sdrf.loops_run, maxprod.launches - before, seconds)
    (lists, loops, k5, seconds), (plain_lists, plain_loops, plain_k5, plain_s) = runs["K5"], runs["plain"]
    added, removed = lists
    if lists != plain_lists or loops != plain_loops:
        raise AssertionError("SDRF through K5 differs from SDRF through the plain version")
    if k5 != 2 * loops or plain_k5 != 0:
        raise AssertionError(f"SDRF: {k5} K5 launches in {loops} loops (want 2 per loop), {plain_k5} in the plain run")
    mesh = set(zip(snd.tolist(), rcv.tolist()))
    removed_mesh = sum((s, r) in mesh for s, r in zip(removed["senders"], removed["receivers"]))
    log(
        f"SDRF 40x40 flag (loops 150, tau 150, removal): {loops} loops run, {len(added['senders'])} edges "
        f"added, {len(removed['senders'])} removed ({removed_mesh} of them mesh edges), both directions; "
        f"{k5} K5 launches; {seconds:.3f} s through K5, {plain_s:.3f} s through the plain version; "
        f"equal lists [{card}]"
    )
    return dict(
        loops_run=loops, added=len(added["senders"]), removed=len(removed["senders"]),
        removed_mesh_edges=removed_mesh, k5_launches=k5, seconds=seconds, plain_seconds=plain_s,
    )


HALO_RANKS = 4  # the halo forward's rank group, all on cuda:0
HALO_BANDS = 4  # K7's node-row bands
HALO_CHUNK = 256  # the round-robin layout's chunk (the JAX package's default_chunk())
HALO_TIMED = 50  # halo forwards timed per path
RING_CALLS = 100  # K6 calls in a row (the epochs)


def one_card_group(n):
    """A rank group of n ranks on cuda:0 (the contract's one card)."""
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    return RankGroup(n, devices=["cuda:0"] * n)


def group_time_ms(group, fn, iters, warmup=3):
    """Device time per call of ``fn``, which enqueues one collective on the
    ranks' streams: CUDA events on the current stream around ``iters``
    calls, the ranks' streams fenced to it on both sides."""
    import torch

    for _ in range(warmup):
        fn()
    group.check()
    cur = torch.cuda.current_stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(cur)
    for s in group.streams:
        s.wait_stream(cur)
    for _ in range(iters):
        fn()
    for s in group.streams:
        cur.wait_stream(s)
    end.record(cur)
    group.check()
    return start.elapsed_time(end) / iters


GATE_CYCLES = 200_000_000  # torch.cuda._sleep before a gated run: about 0.1 s at 1.98 GHz


def gated_time_ms(group, fn, iters, warmup=3):
    """``(device ms, host ms)`` per call of ``fn``.  The device time is taken
    with every rank's stream held behind one event until the host has
    enqueued all ``iters`` calls: a
    ``torch.cuda._sleep`` on the current stream, an event after it that
    every rank's stream waits for and that starts the clock, then the calls.
    The first call's kernels of every rank start together and the later
    calls find their work queued, so this is the kernels' own pace, free of
    the host's launch path; the host time is the enqueue's (host clock), the
    launch path's own cost.  The sleep doubles (up to three times) until it
    outlasts the host's enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    group.check()
    cur = torch.cuda.current_stream()
    cycles = GATE_CYCLES
    for _ in range(4):
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record(cur)
        torch.cuda._sleep(cycles)
        start.record(cur)
        for s in group.streams:
            s.wait_stream(cur)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        for s in group.streams:
            cur.wait_stream(s)
        end.record(cur)
        group.check()
        if host_ms < before.elapsed_time(start):
            return start.elapsed_time(end) / iters, host_ms / iters
        cycles *= 2
    raise RuntimeError(f"the gate ({before.elapsed_time(start):.1f} ms) never outlasted the host's enqueue "
                       f"({host_ms:.1f} ms)")


def traced_launch_ms(group, fn, iters, name):
    """Mean traced device time of one launch of the kernel ``name`` (each
    call of ``fn`` launches it once per rank), retraced as kernel_device_ms
    does when the trace drops every record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    group.check()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            group.check()
        times = [us for kname, us in device_kernels(prof) if name in kname]
        if len(times) != iters * group.n:
            log(f"trace {attempt} of {TRACE_ATTEMPTS}: {len(times)} of {iters * group.n} {name} launches recorded")
        if times:
            return sum(times) / len(times) / 1e3
    raise RuntimeError(f"no trace of {name} recorded a launch in {TRACE_ATTEMPTS} attempts")


def ring_bounds_ms(n, payload_bytes, peaks) -> dict:
    """K6's bounds on one card: ``bound_ms`` for the function (n partials
    read, n results written); ``ring_bound_ms`` for the least traffic of the
    hop schedule, 2nP bytes per rank (x read and out written once, each of
    the n-1 messages written once and read once), summed over the ranks
    sharing the card; ``ring_bound_as_built_ms`` for the bound it replaced,
    2P + 4P(n-1) per rank (the traffic of a ring that copies, then folds:
    per hop P sent and the received P folded into out)."""
    bw = peaks[1]
    return dict(
        bound_ms=2 * n * payload_bytes / bw * 1e3,
        bound_by="bytes",
        ring_bound_ms=n * 2 * n * payload_bytes / bw * 1e3,
        ring_bound_as_built_ms=n * (2 + 4 * (n - 1)) * payload_bytes / bw * 1e3,
    )


def phase_ring(card, peaks, seed):
    """K6 against its plain version bit for bit: 2, 3 and 4 ranks at the
    halo forward's payload [4N, L] = [6400, 128] float32 with the pna
    segments, an odd shape, a rank whose launch comes late, and 100 calls in
    a row; timed beside its bounds."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.ring import (
        ring_all_reduce_segments,
        ring_all_reduce_segments_reference,
    )

    gen = torch.Generator().manual_seed(seed + 4)
    N, L = 1600, L_MAIN
    pna = lambda n_rows: [(0, n_rows, "sum"), (n_rows, 2 * n_rows, "sum"),
                          (2 * n_rows, 3 * n_rows, "max"), (3 * n_rows, 4 * n_rows, "min")]

    def check(tag, group, xs, segments, got=None):
        torch.cuda.synchronize()
        got = ring_all_reduce_segments(xs, segments, group) if got is None else got
        group.check()
        want = ring_all_reduce_segments_reference(xs, segments)
        for r in range(group.n):
            if not torch.equal(got[r], want[r]):
                bad = int((got[r] != want[r]).sum())
                raise AssertionError(f"K6 {tag}: rank {r} differs from the plain version in {bad} elements")

    results = {}
    for n in (2, 3, 4):
        group = one_card_group(n)
        xs = [torch.randn(4 * N, L, generator=gen).cuda() for _ in range(n)]
        check(f"n={n} [{4 * N}, {L}]", group, xs, pna(N))
        run = lambda: ring_all_reduce_segments(xs, pna(N), group)
        ms = group_time_ms(group, run, iters=50)
        gated_ms, host_ms = gated_time_ms(group, run, iters=50)
        launch_ms = traced_launch_ms(group, run, iters=20, name="ring_kernel")
        plain_ms = cuda_time_ms(lambda: ring_all_reduce_segments_reference(xs, pna(N)), iters=10)
        bounds = ring_bounds_ms(n, 4 * N * L * 4, peaks)
        results[n] = dict(max_abs_err=0.0, ms=ms, gated_ms=gated_ms, host_ms=host_ms, launch_ms=launch_ms,
                          plain_ms=plain_ms,
                          **bounds)
        log(
            f"K6 n={n} ranks on one card, payload [{4 * N}, {L}] float32: {ms * 1e3:.1f} us per ring "
            f"(CUDA events, all ranks), {gated_ms * 1e3:.1f} us per ring gated (every rank's launch "
            f"queued before the first starts; the host enqueues a call in {host_ms * 1e3:.1f} us), "
            f"{launch_ms * 1e3:.1f} us per rank's launch (traced, spins "
            f"included); bound {bounds['bound_ms'] * 1e3:.2f} us (bytes), ring traffic 2nP per rank "
            f"{bounds['ring_bound_ms'] * 1e3:.2f} us (a copy-then-fold ring's 2P + 4P(n-1): "
            f"{bounds['ring_bound_as_built_ms'] * 1e3:.2f} us); plain {plain_ms:.3f} ms; bit for bit [{card}]"
        )

    group = one_card_group(3)
    xs = [torch.randn(4 * 251, 37, generator=gen).cuda() for _ in range(3)]
    check("odd [1004, 37], n=3", group, xs, pna(251))
    segs = [(0, 300, "max"), (300, 700, "sum"), (900, 1004, "min")]  # rows 700-900 keep x_r
    check("odd segments", group, xs, segs)
    log("K6 odd shape [1004, 37] (scalar path) and uneven segments with uncovered rows: bit for bit")

    group = one_card_group(4)
    xs = [torch.randn(4 * N, L, generator=gen).cuda() for _ in range(4)]
    torch.cuda.synchronize()
    with torch.cuda.stream(group.stream(1)):
        torch.cuda._sleep(20_000_000)  # rank 1 starts about 10 ms late
    check("rank 1 delayed", group, xs, pna(N), got=ring_all_reduce_segments(xs, pna(N), group))
    log("K6 with rank 1's launch delayed about 10 ms: bit for bit")

    inputs, outputs = [], []
    for _ in range(RING_CALLS):
        xs = [torch.randn(4 * N, L, generator=gen).cuda() for _ in range(4)]
        inputs.append(xs)
    torch.cuda.synchronize()
    epoch0 = group.epoch
    for xs in inputs:
        outputs.append(ring_all_reduce_segments(xs, pna(N), group))
    group.check()
    for k, (xs, got) in enumerate(zip(inputs, outputs)):
        check(f"call {k} of {RING_CALLS}", group, xs, pna(N), got=got)
    log(f"K6 {RING_CALLS} calls in a row (epochs {epoch0 + 1} to {group.epoch}), no sync between: bit for bit")
    return results


def overlap_shards(dtype, gen, n=HALO_RANKS, chunk=HALO_CHUNK):
    """The 40x40 flag's edges padded to chunk * n and dealt round-robin
    (the halo forward's layout), with random K1 inputs on cuda:0: a list of
    the ranks' shard arguments, and N."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
    from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import chunk_roundrobin_permutation, overlap_plan
    from hyper_graph_nets_tpu_torch.parallel.sharding import pad_to_multiple

    edges = cells_to_edges(_grid_triangulation(40, 40))
    N, L, E = 1600, L_MAIN, len(edges.senders)
    snd = pad_to_multiple(edges.senders, chunk * n, 0)
    rcv = pad_to_multiple(edges.receivers, chunk * n, N - 1)
    mask = np.zeros(len(snd), np.float32)
    mask[:E] = 1.0
    perm = chunk_roundrobin_permutation(len(snd), n, chunk)
    snd, rcv, mask = snd[perm], rcv[perm], mask[perm]
    per = len(snd) // n
    x = k1_inputs(dtype, 1, snd[:per], rcv[:per], N, L, gen, "cuda")
    shards = []
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        s, rc = torch.as_tensor(snd[sl]).cuda(), torch.as_tensor(rcv[sl]).cuda()
        shards.append(dict(
            e=torch.randn(per, L, generator=gen).to(dtype).cuda(), sp=x["sp"][0], rp=x["rp"][0],
            weights=x["weights"], senders=s, receivers=rc, mask=torch.as_tensor(mask[sl]).cuda(),
            plan=overlap_plan(rcv[sl], mask[sl], N, HALO_BANDS, senders=snd[sl]).to("cuda"),
        ))
    return shards, N


def phase_overlap(card, peaks, seed):
    """K1 raw and K7 at the halo forward's shard shapes (4 ranks of 2,560
    edges of the 40x40 flag, round-robin): K1 raw against its plain version
    (``phase_kernels`` times it on this shard), K7's e2 against K1's bit for
    bit and its aggregate against K1 raw + the plain all-reduce + finalize;
    K7 timed beside its bounds."""
    import torch

    from hyper_graph_nets_tpu_torch.core.segment_ops import finalize_partials
    from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block_fwd, fused_edge_block_reference
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import (
        fused_edge_block_overlap,
        fused_edge_block_overlap_reference,
    )

    gen = torch.Generator().manual_seed(seed + 5)
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        shards, N = overlap_shards(dtype, gen)
        n, L, E = len(shards), L_MAIN, shards[0]["e"].shape[0]
        group = one_card_group(n)
        topo = lambda x: (x["senders"], x["receivers"], x["mask"], N)
        raw_call = lambda x: fused_edge_block_fwd(
            x["e"][None], x["sp"][None], x["rp"][None], x["weights"], *topo(x), x["plan"], raw=True
        )
        # K1 raw against its plain version, on every rank's shard
        raws, err = [], 0.0
        for r, x in enumerate(shards):
            e2, raw = raw_call(x)
            torch.cuda.synchronize()
            re2, rraw = fused_edge_block_reference(
                x["e"][None], x["sp"][None], x["rp"][None], x["weights"], *topo(x), raw=True
            )
            err = max(err, check_close(f"K1 raw {dtype_name} rank {r} e2", e2, re2, *TOL[dtype_name]["e2"]))
            err = max(err, check_close(f"K1 raw {dtype_name} rank {r} agg", raw, rraw, *TOL[dtype_name]["agg"]))
            raws.append((e2[0], raw[0]))
        results[("K1 raw", dtype_name)] = dict(max_abs_err=err)
        log(f"K1 raw {dtype_name} {n} shards E={E} N={N} L={L}: max abs err {err:.3g} [{card}]")

        # K7 against the separate pass: K1 raw + the plain all-reduce + finalize
        torch.cuda.synchronize()
        got = fused_edge_block_overlap(shards, N, group, HALO_BANDS)
        group.check()
        acc = raws[0][1][:, : 2 * L]
        for _, raw in raws[1:]:  # the plain all-reduce: rank order 0 .. n-1
            acc = acc + raw[:, : 2 * L]
        total = torch.cat([
            acc,
            torch.stack([r[1][:, 2 * L : 3 * L] for r in raws]).amax(0),
            torch.stack([r[1][:, 3 * L :] for r in raws]).amin(0),
        ], dim=-1)
        want = finalize_partials(total)
        agg_tol = 1e-6 if dtype_name == "float32" else TOL["bfloat16"]["agg"][0]
        err7 = 0.0
        for r in range(n):
            if not torch.equal(got[r][0], raws[r][0]):
                raise AssertionError(f"K7 {dtype_name} rank {r}: e2 differs from K1's on the same shard")
            err7 = max(err7, check_close(f"K7 {dtype_name} rank {r} agg", got[r][1], want, agg_tol, agg_tol))
        run7 = lambda: fused_edge_block_overlap(shards, N, group, HALO_BANDS)
        ms7 = group_time_ms(group, run7, iters=50)
        gated7, host7 = gated_time_ms(group, run7, iters=20)
        launch7 = traced_launch_ms(group, run7, iters=20, name="fused_overlap_kernel")
        plain7 = cuda_time_ms(lambda: fused_edge_block_overlap_reference(shards, N), iters=5)
        k1b, by7 = k1_bound_ms(dtype_name, 1, E, N, L, peaks)
        ring_b = ring_bounds_ms(n, N * 4 * L * 4, peaks)
        results[("K7", dtype_name)] = dict(
            max_abs_err=err7, ms=ms7, gated_ms=gated7, host_ms=host7, launch_ms=launch7, plain_ms=plain7,
            bound_ms=n * k1b,
            bound_by=by7,
            ring_bound_ms=n * k1b + ring_b["ring_bound_ms"],
        )
        log(
            f"K7 {dtype_name} {n} ranks on one card, shard E={E}, {HALO_BANDS} bands: {ms7 * 1e3:.1f} us per "
            f"call (CUDA events, all ranks), {gated7 * 1e3:.1f} us per call gated (host enqueue "
            f"{host7 * 1e3:.1f} us), {launch7 * 1e3:.1f} us "
            f"per rank's launch (traced); bound "
            f"{n * k1b * 1e3:.2f} us ({by7}), with the ring's traffic {results[('K7', dtype_name)]['ring_bound_ms'] * 1e3:.2f} us; "
            f"plain {plain7:.3f} ms; e2 bit for bit with K1, agg max abs err {err7:.3g} [{card}]"
        )
    return results


def phase_halo(card, seed):
    """Serve flag MGN-15MP through the halo forward over 4 ranks on one
    card: agg_vjp fused (K1 raw + plain all-reduce), xla with the ring (K6)
    and fused with overlap (K7); launch counts, the card against the
    single-device forward and the CPU, ms per forward."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph
    from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology

    traj = add_targets(flag_trajectory(num_steps=4, nx=40, ny=40, seed=seed), "world_pos", history=True)
    frame_np = {k: v[0] for k, v in traj.items() if k != "cells"}
    group = one_card_group(HALO_RANKS)
    log(f"rank group: {group.n} ranks, torch.cuda.device_count() = {torch.cuda.device_count()}; "
        f"{group.layout()} (one card: a ring's remote writes land in its own memory)")
    launches, timings = dict.fromkeys(read_counts(), 0), {}
    for path, agg_vjp, ring, overlap, kernel in (
        ("fused", "fused", False, False, "K1"),
        ("ring", "xla", True, False, "K6"),
        ("overlap", "fused", False, True, "K7"),
    ):
        config = main_config(agg_vjp=agg_vjp)
        model = get_model(config)
        cfg = model.gnn_config
        check_mgn15(cfg, agg_vjp)
        blocks = cfg.message_passing_steps
        state = model.init_state(torch.Generator().manual_seed(seed))
        topo_cpu = model.topology_from_trajectory(traj, device="cpu")
        frames_cpu = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
        with torch.no_grad():
            _, _, state = model.make_graph(state, topo_cpu, frames_cpu, True)
        state_card = state.to("cuda")
        topo = model.topology_from_trajectory(traj, device="cuda")
        frame = {k: torch.as_tensor(v, device="cuda") for k, v in frame_np.items()}
        stopo = shard_topology(topo, group, overlap_bands=HALO_BANDS if overlap else None)
        with torch.no_grad():
            graph, _, _ = model.make_graph(state_card, stopo, frame, False)
            single_graph, _, _ = model.make_graph(state_card, topo, frame, False)
        rank_graphs = split_graph(graph, group)
        fwd = make_halo_forward(model, group, ring=ring, overlap=overlap)
        E_rank = rank_graphs[0].edge_sets["mesh_edges"].num_edges

        # the main path: every count set to 0 just before, read just after
        reset_counts()
        outs = fwd(state_card, rank_graphs, all_ranks=True)
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want[kernel] = blocks * group.n
        if counts != want:
            raise AssertionError(f"halo forward ({path}) launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        with torch.no_grad():
            single = model.forward(state_card, single_graph)
            cpu_graph, _, _ = model.make_graph(state, topo_cpu, {k: v[0] for k, v in frames_cpu.items()}, False)
            cpu_out = model.forward(state, cpu_graph)
        scale = float(cpu_out.abs().max())
        errs = dict(
            ranks=max(float((o - outs[0]).abs().max()) for o in outs),
            single_card=float((outs[0] - single).abs().max()),
            cpu=float((outs[0].cpu() - cpu_out).abs().max()),
        )
        if outs[0].shape != (1600, 3) or not bool(torch.isfinite(outs[0]).all()):
            raise AssertionError(f"halo forward ({path}): output {tuple(outs[0].shape)} not finite/shaped")
        if max(errs.values()) > SERVE_TOL["net_out"] * scale:
            raise AssertionError(f"halo forward ({path}) outside {SERVE_TOL['net_out']} of max {scale}: {errs}")

        def host_ms(fn, n):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        ms = host_ms(lambda: fwd(state_card, rank_graphs), HALO_TIMED)
        with torch.no_grad():
            single_ms = host_ms(lambda: model.forward(state_card, single_graph), HALO_TIMED)
        timings[path] = dict(
            ms_per_forward=ms, single_device_ms=single_ms, edges_per_rank=E_rank, launches=counts[kernel],
            max_err_vs_ranks=errs["ranks"], max_err_vs_single=errs["single_card"], max_err_vs_cpu=errs["cpu"],
            out_scale=scale,
        )
        log(
            f"halo forward ({path}, agg_vjp {agg_vjp}) flag MGN-15MP latent 128 bf16, 40x40, {group.n} ranks "
            f"of {E_rank} edges: {counts[kernel]} {kernel} ({blocks} per rank); {ms:.2f} ms per forward "
            f"(host clock, {HALO_TIMED} calls) vs single-device forward B=1 {single_ms:.2f} ms; max err "
            f"ranks {errs['ranks']:.3g}, vs single-device {errs['single_card']:.3g}, vs CPU {errs['cpu']:.3g} "
            f"of max {scale:.3g} [{card}]"
        )
    return launches, timings


def phase_slice(card, seed, rollout_steps, profile_dir=None, agg_vjp="fused", balancer=False):
    """Serve MGN-15MP through the port's Predictor; returns timings and counts.
    With ``balancer`` the configuration's Ricci balancer is on: each call
    runs SDRF in ``prepare`` (K5) and serves the expanded graph."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import batched_forward

    config = balancer_config(agg_vjp=agg_vjp) if balancer else main_config(agg_vjp=agg_vjp)
    predictor = Predictor.from_config(config)
    model = predictor.model
    cfg = model.gnn_config
    check_mgn15(cfg, agg_vjp, balancer)
    kernel = "K1" if agg_vjp == "fused" else "K4f"
    path = agg_vjp + (" + ricci balancer" if balancer else "")
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
    log(f"serving ({path}): flag MGN-15MP latent 128 bf16, N={N} E={E}, one_step B={B}, "
        f"rollout {rollout_steps}")

    # the main path: every count set to 0 just before, read just after; with
    # the balancer, each call's prepare runs SDRF (2 K5 per loop run)
    reset_counts()
    pred = predictor.one_step(batch)
    loops = [sdrf.loops_run] if balancer else []
    launches_one_step = read_counts()
    result = predictor.rollout(traj, num_steps=rollout_steps)
    loops += [sdrf.loops_run] if balancer else []
    launches = read_counts()
    want = dict.fromkeys(launches, 0)
    want[kernel] = blocks * (1 + rollout_steps)
    want["K5"] = 2 * sum(loops)
    if launches_one_step[kernel] != blocks or launches != want:
        raise AssertionError(
            f"serving launches: {launches_one_step} in one_step (want {kernel} {blocks}), "
            f"{launches} in all (want {want})"
        )
    static = predictor.expansion.static if balancer else None
    if balancer:
        bstat = static[0]
        log(f"balancer: SDRF ran {loops} loops per prepare; {int(bstat.bal_mask.sum())} balance edges "
            f"(capacity {bstat.bal_mask.numel()}), {int((bstat.mesh_keep == 0).sum())} mesh edges removed")
    if pred.shape != (B, N, 3) or not np.isfinite(pred).all():
        raise AssertionError(f"one_step output {pred.shape} not finite/shaped")
    if result["pred_pos"].shape != (rollout_steps, N, 3) or not (
        np.isfinite(result["pred_pos"]).all() and np.isfinite(result["mse"]).all()
    ):
        raise AssertionError("rollout output not finite/shaped")
    log(f"serving launches: {launches_one_step[kernel]} {kernel} per one_step, {launches} in all")

    # the card against the CPU, same state and (with the balancer) the same
    # static, bf16 on both
    cpu = Predictor(config, state=predictor.state, device="cpu")
    pred_cpu = cpu.one_step(batch, static=static)
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
            if balancer:
                g, _ = p.expansion.expand(p.state, g, fr, p.model, False, static=static)
            outs.append(batched_forward(p.model, p.state.params, g).cpu())
    out_err = float((outs[0] - outs[1]).abs().max())
    out_scale = float(outs[1].abs().max())
    log(
        f"one_step ({path}) card vs CPU: net out max err {out_err:.4g} of max {out_scale:.4g}; "
        f"acceleration max err {acc_err:.4g} of max {acc_scale:.4g}"
    )
    if out_err > SERVE_TOL["net_out"] * out_scale or acc_err > SERVE_TOL["acceleration"] * acc_scale:
        raise AssertionError(f"one_step card vs CPU outside tolerance {SERVE_TOL}")

    # timings (host clock around synchronized work); with the balancer,
    # one_step with its prepare (SDRF) and with the prepared static
    def host_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(times))

    one_step_ms = host_ms(lambda: predictor.one_step(batch, static=static), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.rollout(traj, num_steps=rollout_steps, static=static)
    rollout_ms_step = 1e3 * (time.perf_counter() - t0) / rollout_steps
    timings = dict(
        one_step_ms=one_step_ms,
        one_step_edges_per_s=B * E / (one_step_ms / 1e3),
        rollout_ms_per_step=rollout_ms_step,
        rollout_edges_per_s=E / (rollout_ms_step / 1e3),
        one_step_vs_cpu_net_out_err=out_err,
        one_step_vs_cpu_acceleration_err=acc_err,
    )
    extra = ""
    if balancer:
        frame0 = {k: v[0] for k, v in traj.items()}
        topo_card = predictor._topology(traj)

        def prepare():
            predictor.expansion.reset(0, 1)
            predictor.expansion.prepare(model, frame0, topo_card)

        timings["prepare_s"] = host_ms(prepare, 3) / 1e3
        timings["one_step_with_prepare_ms"] = host_ms(lambda: predictor.one_step(batch), 3)
        extra = (f"; with its prepare (SDRF) {timings['one_step_with_prepare_ms']:.2f} ms, "
                 f"prepare alone {timings['prepare_s']:.3f} s")
    log(
        f"one_step ({path}) B={B}: {one_step_ms:.2f} ms, "
        f"{timings['one_step_edges_per_s']:.4g} edges/s{extra} [{card}]"
    )
    log(
        f"rollout ({path}): {rollout_ms_step:.2f} ms/step, "
        f"{timings['rollout_edges_per_s']:.4g} edges/s [{card}]"
    )
    if profile_dir:
        tag = agg_vjp + ("_balancer" if balancer else "")
        timings["profile"] = {
            "one_step": device_profile(
                lambda: predictor.one_step(batch, static=static), card, profile_dir, f"one_step_{tag}"
            ),
            "rollout_5_steps": device_profile(
                lambda: predictor.rollout(traj, num_steps=5, static=static), card, profile_dir, f"rollout_{tag}"
            ),
        }
    return launches, timings


def main_config(**model):
    """configs/flag_full_scale.yaml with RMP off (as bench.py:109 does)."""
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml("flag_full_scale")
    config["params"]["model"]["rmp"].update(clustering="none", connector="none")
    config["params"]["model"].update(model)
    return config


def balancer_config(**model):
    """``main_config`` with the Ricci balancer on; every other balancer key
    (loops 150, tau 150, remove_edges, frequency 1) from the file."""
    config = main_config(**model)
    bal = config["params"]["model"]["graph_balancer"]
    bal["algorithm"] = "ricci"
    if (bal["ricci"]["loops"], bal["ricci"]["tau"], bal["remove_edges"], bal["frequency"]) != (150, 150, True, 1):
        raise AssertionError(f"flag_full_scale's graph_balancer changed: {bal}")
    return config


def check_mgn15(cfg, agg_vjp="fused", balancer=False):
    if (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp, cfg.compute_dtype) != (
        128, 15, agg_vjp, "bfloat16"
    ):
        raise AssertionError(f"flag_full_scale is not MGN-15MP with agg_vjp {agg_vjp}: {cfg}")
    sets = ("mesh_edges", "balance") if balancer else ("mesh_edges",)
    if cfg.edge_sets != sets:
        raise AssertionError(f"edge sets {cfg.edge_sets}, want {sets}")


def _counters():
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.ops import fused_overlap as fo
    from hyper_graph_nets_tpu_torch.ops import maxprod as mp
    from hyper_graph_nets_tpu_torch.ops import ring
    from hyper_graph_nets_tpu_torch.ops import segment_pna as sp

    return {
        "K1": fb.fused_edge_block,
        "K2": fb.fused_edge_block_bwd,
        "K3": fb.fused_edge_block_bwd_stream,
        "K4f": sp.pna_sorted,
        "K4b": sp.pna_sorted_bwd,
        "K5": mp.maxprod,
        "K6": ring.ring_all_reduce_segments,
        "K7": fo.fused_edge_block_overlap,
    }


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def phase_train(card, seed, profile_dir=None):
    """Train MGN-15MP through the port's Trainer with each backward: the
    fused path's remat (K2) and stream (K3), the sorted path (K4b), and the
    fused remat path with the Ricci balancer (its prepare runs SDRF, K5)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    traj = add_targets(
        flag_trajectory(num_steps=TRAIN_FRAMES + 2, nx=40, ny=40, seed=seed), "world_pos", history=True
    )
    launches = dict.fromkeys(read_counts(), 0)
    timings, cpu_grads = {}, {}
    frame0 = {k: v[0] for k, v in traj.items()}
    for mode in ("remat", "stream", "sorted", "balancer"):
        agg_vjp = "sorted" if mode == "sorted" else "fused"
        balancer = mode == "balancer"
        bwd = "remat" if balancer else mode
        path = dict(agg_vjp=agg_vjp) if mode == "sorted" else dict(fused_bwd=bwd)
        make_config = balancer_config if balancer else main_config
        config = make_config(**path)
        model = get_model(config)
        cfg = model.gnn_config
        check_mgn15(cfg, agg_vjp, balancer)
        if (mode != "sorted" and cfg.fused_bwd != bwd) or model.noise_scale != 0.003 or model.noise_gamma != 0.9:
            raise AssertionError(f"train config: {cfg}, noise {model.noise_scale}/{model.noise_gamma}")
        blocks = cfg.message_passing_steps
        trainer = Trainer(model, config)
        tstate = trainer.init_train_state(torch.Generator().manual_seed(seed))
        topo = model.topology_from_trajectory(traj, device=trainer.device)
        frames = trainer.frames(traj)
        B = frames["world_pos"].shape[0]
        E, N = int(topo.senders.shape[0]), topo.num_nodes
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        torch.cuda.reset_peak_memory_stats()
        log(f"training ({mode}): flag MGN-15MP latent 128 bf16, B={B} N={N} E={E}, lr {trainer.lr}")

        # the main path: every count set to 0 just before, read just after;
        # with the balancer, the trainer's prepare (SDRF) and one step
        reset_counts()
        static = trainer.expansion.prepare(model, frame0, topo) if balancer else None
        tstate, loss = trainer.train_step(tstate, topo, frames, generator=gen, static=static)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict.fromkeys(launches, 0)
        for k in {"remat": ("K1", "K2"), "stream": ("K1", "K3"), "sorted": ("K4f", "K4b"),
                  "balancer": ("K1", "K2")}[mode]:
            want[k] = blocks
        if balancer:
            want["K5"] = 2 * sdrf.loops_run
        if counts != want:
            raise AssertionError(f"train step ({mode}) launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        log(f"train step ({mode}) launches: {counts}")

        # loss curve on one fixed batch, and the step's time
        losses, step_s = [float(loss)], []
        n = LOSS_STEPS if mode in ("remat", "sorted", "balancer") else 1 + WARMUP_STEPS + TIMED_STEPS
        for _ in range(n - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tstate, loss = trainer.train_step(tstate, topo, frames, generator=gen, static=static)
            losses.append(float(loss))  # waits for the step
            step_s.append(time.perf_counter() - t0)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train ({mode}) losses not finite: {losses}")
        if n == LOSS_STEPS and not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall over {n} steps: {losses[0]} -> {losses[-1]}")
        ms = 1e3 * float(np.median(step_s[WARMUP_STEPS : WARMUP_STEPS + TIMED_STEPS]))
        timings[mode] = dict(
            step_ms=ms, edges_per_s=B * E / (ms / 1e3), first_loss=losses[0], last_loss=losses[-1],
            steps=n, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        log(
            f"train step ({mode}) B={B}: {ms:.2f} ms (median of {TIMED_STEPS} after {WARMUP_STEPS} "
            f"warm-up), {B * E / (ms / 1e3):.4g} edges/s; loss {losses[0]:.5f} -> {losses[-1]:.5f} "
            f"over {n} steps [{card}]"
        )
        if profile_dir:
            timings[mode]["profile"] = device_profile(
                lambda: trainer.train_step(tstate, topo, frames, generator=gen, static=static),
                card, profile_dir, f"train_{mode}",
            )

        # the card against the CPU: same state, noise and (with the
        # balancer) static, B = CPU_FRAMES
        for dtype_name in ("bfloat16", "float32"):
            cmp_config = make_config(**path, compute_dtype=None if dtype_name == "float32" else dtype_name)
            cmp_model = get_model(cmp_config)
            state = cmp_model.init_state(torch.Generator().manual_seed(seed + 1))
            small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
            normal = torch.randn(small["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 2),
                                 dtype=torch.float64)
            grads, losses_cmp = {}, {}
            cpu_key = (agg_vjp, balancer, dtype_name)
            for where in ("cuda", "cpu"):
                if where == "cpu" and cpu_key in cpu_grads:
                    losses_cmp["cpu"], grads["cpu"] = cpu_grads[cpu_key]
                    continue
                tr = Trainer(cmp_model, cmp_config, device=where)
                ts = tr.init_train_state(state=state)
                t = cmp_model.topology_from_trajectory(small, device=where)
                loss, _ = tr.loss_and_grads(ts, t, tr.frames(small), normal=normal.to(where), static=static)
                losses_cmp[where] = float(loss)
                grads[where] = {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()}
            cpu_grads[cpu_key] = (losses_cmp["cpu"], grads["cpu"])
            loss_tol, grad_tol = TRAIN_TOL[dtype_name]
            loss_err = abs(losses_cmp["cuda"] - losses_cmp["cpu"]) / abs(losses_cmp["cpu"])
            errs = {n: rel_l2(grads["cuda"][n], g) for n, g in grads["cpu"].items()}
            own = {n: e for n, e in errs.items() if ".balance." in n and dtype_name == "bfloat16"}
            worst = max((e, n) for n, e in errs.items() if n not in own)
            worst_own = max(((e, n) for n, e in own.items()), default=(0.0, "-"))
            log(
                f"train step ({mode}) {dtype_name} card vs CPU, B={CPU_FRAMES}: loss {losses_cmp['cuda']:.6f} "
                f"vs {losses_cmp['cpu']:.6f} (rel {loss_err:.3g}); worst gradient relative L2 "
                f"{worst[0]:.3g} ({worst[1]})"
                + (f"; of the balance edge models {worst_own[0]:.3g} ({worst_own[1]})" if own else "")
            )
            if loss_err > loss_tol or worst[0] > grad_tol or worst_own[0] > BALANCE_BF16_GRAD_TOL:
                raise AssertionError(f"train step ({mode}) {dtype_name} card vs CPU outside {TRAIN_TOL[dtype_name]}")
            timings[mode][f"vs_cpu_{dtype_name}"] = dict(
                loss_rel=loss_err, worst_grad_rel_l2=worst[0], worst_balance_grad_rel_l2=worst_own[0]
            )
    return launches, timings


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
        help="also trace one one_step, a 5-step rollout and one train step of each "
        "backward with torch.profiler (device busy share, kernel time by name; "
        "Chrome traces into DIR)",
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {os.path.basename(src)}: {line.strip()}")

    # 3. kernels against their plain versions
    edges = cells_to_edges(_grid_triangulation(40, 40))
    topo_np = (edges.senders, edges.receivers, 1600)
    k1 = phase_kernels(card, peaks, topo_np, args.seed)
    bwd = phase_backward(card, peaks, topo_np, args.seed)
    k4 = phase_sorted(card, peaks, topo_np, args.seed)
    k5 = phase_maxprod(card, peaks, topo_np, args.seed)
    sdrf_run = phase_sdrf(card, topo_np)
    k6 = phase_ring(card, peaks, args.seed)
    k7 = phase_overlap(card, peaks, args.seed)

    # 4-5. the main paths, their counts and timings
    serve_launches, serve_timings = {}, {}
    for agg_vjp, balancer in (("fused", False), ("sorted", False), ("fused", True)):
        name = "fused_balancer" if balancer else agg_vjp
        n, serve_timings[name] = phase_slice(card, args.seed, ROLLOUT_STEPS, args.profile, agg_vjp, balancer)
        serve_launches = {k: serve_launches.get(k, 0) + v for k, v in n.items()}
    halo_launches, halo_timings = phase_halo(card, args.seed)
    train_launches, train_timings = phase_train(card, args.seed, args.profile)
    launches = {k: serve_launches[k] + halo_launches[k] + train_launches[k] for k in serve_launches}

    main_k1 = k1[("bfloat16", ONE_STEP_FRAMES)]
    k1_shapes = {"B=21": main_k1, "B=1": k1[("bfloat16", 1)], "raw shard": k1[("bfloat16 raw shard", 1)],
                 "raw contiguous shard": k1[("bfloat16 raw contiguous shard", 1)]}
    shapes = lambda runs: {tag: {"ms": r["ms"], "bound_ms": r["bound_ms"]} for tag, r in runs.items()}
    entry = lambda name, src, pallas, n, r: {
        "name": name,
        "route": "cuda",
        "source": f"hyper_graph_nets_tpu_torch/csrc/{src}",
        "replaces": f"hyper_graph_nets_tpu/ops/pallas/{pallas}",
        "launches": n,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
    }
    kernels = [
        dict(entry("fused_edge_block_fwd (K1)", "fused_block_fwd.cu", "fused_block.py:393", launches["K1"], main_k1),
             shapes=shapes(k1_shapes)),
        dict(entry("fused_edge_block_bwd remat (K2)", "fused_block_bwd.cu", "fused_block.py:1008",
                   launches["K2"], bwd[("K2", "bfloat16")]),
             main_kernel_ms=bwd[("K2", "bfloat16")]["main_kernel_ms"]),
        dict(entry("fused_edge_block_bwd stream (K3)", "fused_block_bwd.cu", "fused_block.py:1284",
                   launches["K3"], bwd[("K3", "bfloat16")]),
             main_kernel_ms=bwd[("K3", "bfloat16")]["main_kernel_ms"]),
        entry("pna_sorted (K4f)", "segment_pna.cu", "segment_pna.py:81", launches["K4f"],
              k4[("K4f", "bfloat16", TRAIN_FRAMES)]),
        entry("pna_sorted_bwd (K4b)", "segment_pna.cu", "segment_pna.py:183", launches["K4b"],
              k4[("K4b", "bfloat16", TRAIN_FRAMES)]),
        dict(entry("maxprod (K5)", "maxprod.cu", "maxprod.py:28", launches["K5"], k5["flag B x A"]),
             shapes=shapes(k5)),
        dict(entry("ring_all_reduce_segments (K6)", "ring.cu", "ring.py:60", launches["K6"], k6[HALO_RANKS]),
             ring_bound_ms=k6[HALO_RANKS]["ring_bound_ms"], gated_ms=k6[HALO_RANKS]["gated_ms"]),
        dict(entry("fused_edge_block_overlap (K7)", "fused_overlap.cu", "fused_overlap.py:171", launches["K7"],
                   k7[("K7", "bfloat16")]),
             ring_bound_ms=k7[("K7", "bfloat16")]["ring_bound_ms"], gated_ms=k7[("K7", "bfloat16")]["gated_ms"]),
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(
                {
                    "card": card,
                    "kind": kind,
                    "k1": {f"{d} B={b}": v for (d, b), v in k1.items()},
                    "backward": {
                        (k if isinstance(k, str) else " ".join(k)): v for k, v in bwd.items()
                    },
                    "sorted": {
                        (k if isinstance(k, str) else " ".join(map(str, k))): v for k, v in k4.items()
                    },
                    "maxprod": k5,
                    "sdrf": sdrf_run,
                    "ring": {f"n={n}": v for n, v in k6.items()},
                    "overlap": {" ".join(k): v for k, v in k7.items()},
                    "halo": halo_timings,
                    "halo_launches": halo_launches,
                    "serving": serve_timings,
                    "serving_launches": serve_launches,
                    "training": train_timings,
                    "training_launches": train_launches,
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
