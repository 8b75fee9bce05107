#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU: build and check its kernels, serve
flag MeshGraphNets (MGN-15MP) through ``Predictor`` and through the halo
forward over a rank group, and train it through ``Trainer``, without and with
the Ricci graph balancer, serve and train flag HyperGraphNets (remote
message passing) as configs/flag_full_scale.yaml ships it, serve and train
cylinder and plate MeshGraphNets as configs/cylinder.yaml and
configs/plate.yaml ship them, and plate HyperGraphNets as
configs/plateCluster.yaml ships it, with and without rmp.fused_tiers,
serve flag, flag HyperGraphNets and plate HyperGraphNets with int8 (W8A8)
weights, serve and train flag HyperGraphNets with HDBSCAN, k-means and a
Gaussian mixture, train flag in pods of processes (a graph row across two
processes sharing the card, and over NCCL where there are cards for it), and run the task
loop of cylinder and plate over meshes of different sizes.

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
   B = 21, 1, 15 and 32 and raw on both halo shard layouts; K2
   (remat backward) and K3 (stream backward) at B = 21 in bf16 and float32,
   with a masked tail and an isolated receiver, with masked edges inside
   segments (as the balancer removes mesh edges), with exactly tied edges,
   at B = 1 and 15, and the routed max/min mass against the exact tie count of
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
   all-reduce + finalize, timed as K6; K1 and K2 in float32 at B = 16 on
   the cylinder and plate meshes of phase 8, with their own plans (plate's
   16 stamp rows aggregate to 0);
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
   (15 per rank), the same forward again bit for bit on every rank, every
   rank against the single-device forward on the card and against the CPU,
   ms per forward (20 calls) beside the single-device forward; then the
   sharded train step (``phase_spmd``, under a watchdog): the same
   configuration trained through ``parallel.sharding.make_spmd_train_step``
   on a 2 x 2 rank group (B = 16, K1 raw + the plain all-reduce, K2) and a
   1 x 4 group with overlap bands (B = 8, batched K7, K2), all ranks on the
   card, with 60 K1 or K7 and 60 K2 a step counted in advance, loss and
   gradients against the single-device step on the card (``SPMD_TOL``),
   twice bit for bit, step ms and edges/s; on the bf16 2 x 2 run a lost
   shard's K2 output must miss the limit (the local-degree control's
   reading logged); a float32 run of each group (on 1 x 4 the local-degree
   control must miss the float32 limit; on 2 x 2, where no receiver's
   edges are split, its reading is logged);
   K1 raw at B = 8, K2 at the global degree on both
   layouts, batched K7 and K6/K7 on sub-rings against their plain versions;
   the halo forward on a 2 x 2 group (ring: K6, overlap: K7); then the
   sharded step with an expansion (``phase_spmd_rmp``, under its own
   watchdog): configs/flag_full_scale.yaml as shipped (RMP) on the same two
   groups (60 K1 raw or K7 and 60 K2 a step over the 1,616 rows, the tier
   sets unfused), against the single-device RMP step on the card
   (``SPMD_RMP_TOL``), twice bit for bit, graph rank 1's up-set partials
   lost as a planted fault that must miss the limit, step ms and edges/s;
   the same file with the Ricci balancer on 2 x 2 (the trainer's prepare:
   2 K5 per SDRF loop; the unmasked topology's degree as a control that
   must miss, over two noise draws); the sorted path cut to
   ``SPMD_SORTED_BLOCKS`` blocks (K4f on each data row's joined mesh shards,
   K4b in its backward: 10 each); ``make_sharded_forward`` with RMP (60
   K1); K1 raw and K2 over 1,616 rows with interior masks, K7 over 1,616
   rows with them, and K4f/K4b on joined shards against their plain
   versions; then the sharded step on the other RMP architectures
   (``phase_spmd_arch``, under its own watchdog): the same file with
   ``rmp.connector`` multiscale, hetero, multi and repeated (clustering
   none), cut to ``SPMD_ARCH_BLOCKS`` blocks, on 2 x 2 at B = 16 (K1 raw +
   K2 per fused mesh call and rank; multi's merged set unfused, no kernel),
   and configs/cylinder.yaml and plate.yaml with the Ricci balancer (2 K5
   per SDRF loop in the trainer's prepare; K1 raw + K2; cylinder also on 1 x
   4 with overlap bands, K7 + K2), each against the single-device step with
   a planted fault (a graph rank's partials zeroed; on 1 x 4 the keep mask
   in the unsharded order), twice bit for bit, and the sharded forward;
   then the hybrid (``phase_hybrid``, ``model.fused_fwd: xla``) on the flag
   file (bf16, B = 21) and configs/cylinder.yaml (float32, B = 16): K2 with
   the tie tolerance against its plain version on the hybrid forward's drhs,
   the near ties it routes and the extrema that tie_tol 0 leaves unwon
   counted, a train step (15 or 5 K2 with the tolerance, no K1) and, on
   flag, a one_step (no kernel) counted, against the CPU and the fused
   K1/K2 step, step times in turns;
5. training: ``Trainer.train_step`` on the same configuration, B = 21, Adam
   at lr 1e-4, noise 0.003, gamma 0.9, with ``fused_bwd: remat``, then
   ``stream``, then ``agg_vjp: sorted``, then remat with the balancer; the
   launch counts read around one step of each (15 K1 and 15 K2, 15 K1 and
   15 K3, or 15 K4f and 15 K4b; with the balancer also the trainer's
   prepare: 2 K5 per SDRF loop); the card's loss and gradients held against
   the same state, noise and static on the CPU (B = 2, bf16 and float32);
   the loss after 30 steps on one batch below the first step's (remat,
   sorted, balancer); train-step ms (median of 10 after 3 warm-up steps)
   and edges/s; then the balancer on ``agg_vjp: sorted`` (15 K4f + 15 K4b
   and the prepare's K5) and ``gather`` (K5 only), and the random balancer
   (``graph_balancer.algorithm: random``, fused: 15 K1 + 15 K2), each cut
   to 14 steps and held against the CPU in float32 only;
6. the task loop: ``get_task`` on the same configuration with the file's
   own task settings (2 training trajectories of 60 frames on the 40x40
   flag, 57 frames each, B = 21, 1 epoch, 10-step n-step windows), written
   to and read from a temporary data directory: ``run_iterations`` (fit,
   then the one-step, rollout and n-step evaluators on the validation
   split, the GIF and the checkpoint) and ``get_scalars`` (the evaluators
   on the test split), with the launches read around fit and each
   evaluator (15 K1 and 15 K2 per fit batch at B = 21 and 15; 15 K1 per
   forward of the one-step evaluator at B = 21 and 15, of the rollout
   evaluator at B = 1 and of the n-step evaluator at B = 32 and 15) and
   finite scalars; a second task on the same directory resumes at epoch 1
   and launches nothing; ``Predictor.from_config(checkpoint=...)`` serves
   the task's state bit for bit; the one-step and n-step evaluators' scalars
   against the CPU's on the same state (the n-step over 4 windows); the
   rollout (20 steps) and n-step evaluators under ``inference_quant: int8``
   on the same state, card against CPU (TASK_INT8_TOL; no kernel launched,
   int8 products counted, the training state float and as it was after,
   one flipped weight code planted); the epoch's seconds, fit edges/s,
   rollout-evaluator ms/step and n-step-evaluator seconds;
7. remote message passing (``phase_rmp``): configs/flag_full_scale.yaml as
   shipped (spectral clustering into 16 clusters on the host, scipy only;
   ``connector: hyper``; 15 hierarchical blocks, bf16, fused remat) served
   (``one_step`` B = 21 and a 20-step ``rollout``, each call reclustering
   in its prepare, timed on a line of its own) and trained (B = 21, the
   loss after 30 steps below the first step's) with 15 K1 per forward and
   15 K2 per train step, the mesh set planned over the 1,616 rows; K1 and
   K2 at those rows against their plain versions (the 16 hyper rows
   receive nothing); the same train step twice, with RMP and with the
   balancer, bit for bit without PyTorch's deterministic algorithms; the
   card against the CPU at B = 2 (loss, gradients, one_step accelerations;
   RMP_TOL) and again with planted K1 faults, which must break it, and with
   one dropped intra_cluster_to_mesh edge (in bf16 also all of one
   cluster's), one of which must break the cluster tier's own limit
   (RMP_TIER_CONTROL); in float32 also the card fed the CPU's expand outputs
   (a bisection of the cluster tier's spread; held to the same limits);
   whether scikit-learn is installed (information only); the same file on
   ``agg_vjp: gather`` and ``xla`` (``rmp_unfused_paths``): one_step
   B = 21, a 5-step rollout and a train step at full depth with no kernel
   launched (counted), the card against the CPU in float32 (RMP_TOL);
8. cylinder and plate (``phase_model``): configs/cylinder.yaml and
   configs/plate.yaml as shipped (latent 128, 5 blocks, float32, fused
   remat, batch 16), seeded weights, normalizers accumulated over a 53-frame
   synthetic trajectory at the published datasets' scale (cylinder 59 x 32,
   1,888 nodes, 10,966 mesh edges; plate 36 x 36 with a 16-node stamp,
   1,312 nodes, 5,040 mesh edges, world edges at the auto capacity):
   ``one_step`` B = 16 and a 50-step ``rollout`` with 5 K1 per forward (the
   world edges unfused), the card's one_step against the CPU's, plate's
   world edges and their fixed-order sums built with host syncs an error,
   a train step (5 K1 + 5 K2), the loss after 30 steps below the first's,
   the same step twice bit for bit, the card against the CPU at B = 2
   (MODEL_TOL);
9. HGN plate (``phase_hgn_kernels``, ``phase_hgn``): configs/plateCluster.yaml
   as shipped (spectral clustering into 16 clusters, connector hyper, 5
   hierarchical blocks, latent 128, float32, fused remat, batch 16) on the
   plate of phase 8: K1 and K2 at B = 16 on the mesh set over its 1,328
   rows and on the up, down and inter sets over their valid-prefix plans
   against their plain versions; with rmp.fused_tiers off (as shipped) and
   on, ``one_step`` B = 16 and a 50-step rollout (5, or with fused_tiers
   20, K1 per forward), two train steps bit for bit, a train step's
   launches (5 or 20 K1 and K2) and time, the card against the CPU at B = 2
   (HGN_TOL) with planted K1 faults, a dropped intra_cluster_to_mesh edge
   and, with fused_tiers, a tier set's lost aggregate row, each of which
   must break a limit;
10. int8 serving (``phase_int8``): ``Predictor(quantize="int8")`` on
   configs/flag_full_scale.yaml with RMP off (fused as shipped: every set
   unfused under int8, no K1; then sorted: 15 K4f a forward), as shipped
   (RMP) and configs/plateCluster.yaml as shipped, seeded weights and
   accumulated normalizers: one_step (B = 21 or 16) and a rollout (50
   steps flat, 20 on the RMP paths) with the launches counted and one int8
   product a dense layer, as many as the CPU makes; ``dense_int8`` on the
   card bit for bit with the CPU at every (rows, in, out) the main paths
   gave it, on their activations and in bf16 (the ones ``torch._int_mm``
   takes only padded among them); the card against the CPU at B = 2 layer
   by layer (the int8 state and every dense layer on the card's input bit
   for bit; one flipped weight code must break it) and end to end
   (INT8_TOL; every 64th row of each int8 product lost must break it);
   int8 against float on the same state (context) and both paths' one_step
   and rollout times;
11. clustering with a variable cluster count (``phase_cluster``): the same
   file with ``rmp.clustering: hdbscan`` and its ``hdbscan:`` block at 15
   blocks, reclustered at two frames (CLUSTER_FRAMES) whose padded cluster
   counts Kp differ (logged when the trajectory gives one Kp), each
   followed by ``one_step`` B = 21, a 10-step rollout and 3 train steps
   (15 K1 a forward, 15 K1 + 15 K2 a step, counted), the mesh plan over
   N + Kp rows after each, K1 and K2 at those rows against their plain
   versions, the card against the CPU at B = 2 in float32 (RMP_TOL) and
   bf16 (RMP_TOL, the cluster tier CLUSTER_TIER_TOL, again with the CPU's
   expand outputs fed in, and a planted tier fault that must break a
   limit);
   then ``kmeans`` and
   ``gmm`` (16 clusters) at CLUSTER_BLOCKS blocks, one_step and one train
   step each, held the same way; K, Kp and each recluster's host seconds
   logged; the pod (``phase_pod``): two processes started with
   ``--pod-worker``, sharing the card, joined over ``gloo``,
   flag_full_scale with RMP off at a global B = 8: first a 2 x 2 pod (each
   process's two ranks name the card twice: a data row a process), one
   train step each (30 K1 raw + 30 K2), bit for bit between the processes
   and against the in-process 2 x 2 step (SPMD_TOL; the summed gradients
   POD_GRAD_TOL), host ms beside it; then a 1 x 2 pod whose graph row spans
   the two processes, fused (15 K1 raw + 15 K2 a process) and sorted (15
   K4f + 15 K4b a process on the row's shards joined across them), bit for
   bit with the in-process 1 x 2 step, a planted control (the other
   process's cotangents dropped) past SPMD_TOL, host ms in turns with the
   in-process step; 20 K6 calls across the two processes on the one card
   (CUDA IPC, time-sliced), each bit for bit with the plain fold; K1 raw and
   K2 at both layouts' shards and K4f/K4b on the joined row against their
   plain versions; the pod over NCCL (``phase_pod_cards``, only with two or
   more cards: with one it prints ``{"phase": "pod_cards", "ran": false,
   "cards": 1}``): a process on cards of its own, 1 x 4 (2 processes x 2
   cards) and 2 x 2 (4 x 1), the fused and overlap-banded steps and the
   halo forward with ring (K6) and overlap (K7) across the processes, bit
   for bit with the in-process group over the same cards, K6/K7 timed per
   rank in turns with it; the sharded step
   over several cards (``phase_spmd_cards``,
   only with two or more: with one it prints
   ``{"phase": "spmd_cards", "ran": false, "cards": 1}`` and runs nothing):
   the ``spmd`` configuration on 2 x 2 at B = 16 over ``min(4, cards)``
   cards and on 1 x 4 with overlap bands at B = 8 (rank r on
   ``cuda:(r % cards)``), its launches counted per card, loss and
   gradients against the same group on one card (SPMD_TOL), a step with
   the cross-card gradient sum left out that must miss the gradient
   limit, every card's parameter copy bit for bit after three steps, two
   runs of three steps bit for bit, host ms beside the one-card group's in
   turns;
12. meshes of different sizes (``phase_bucketed``): configs/cylinder.yaml
   and plate.yaml as shipped through ``get_task`` over datasets written in
   the real schema whose meshes differ in size (``BUCKET_MESHES``: cylinder
   1,824-1,900 nodes, plate 1,234-1,312), padded to one capacity:
   ``run_iterations`` and ``get_scalars`` with K1 and K2 counted
   (``bucket_launches``), every topology at the capacity with a plan and a
   masked tail (plate's at the bucket's obstacle and world capacities),
   K1/K2 on the smallest mesh's padded topology against their plain
   versions, the test mesh padded against unpadded on the card (one-step
   scalars equal, rollout and n-step losses n / C of the unpadded ones,
   the padded rows 0; BUCKET_TOL), the epoch's seconds and (cylinder) busy
   share;
13. the CLI (``phase_cli``): ``python -m hyper_graph_nets_tpu_torch.main``
   on flag_fused_demo (twice, the second run resuming), flag_full_scale,
   cylinder_demo, plate_demo and plateCluster_demo (bf16 demos, RMP as
   shipped), each config in a process of its own, all started together;
14. timings, each with the card (with --profile also the device's busy share
   and kernel time by name), the kernels' JSON line, then the device JSON
   line last.

Exits non-zero without a result when there is no CUDA device, or when the
port's package is not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import weakref

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
# for the worst gradient.)  Both sides run with PyTorch's deterministic
# algorithms (``fixed_scatter_order``).  Without it the balance edge set's
# sums once went through PyTorch's atomic scatter-adds, whose float32 order
# changed from run to run and moved a balance edge model's gradients past
# 1e-3 about one run in a thousand (``tools/torch_port/train_spread.py``;
# PERF.md section 6); every unplanned set now sums in a fixed order
# (``core.segment_ops.FixedSum``, held bit for bit by ``phase_rmp``), and
# the wrapper stays as a second guard.
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
TASK_LAST_BATCH = 15  # the task loop's batches of 57 frames: 21, 21, 15
TASK_N_STEP_CHUNK = 32  # the n-step evaluator's windows per batch
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
    TRACE_ATTEMPTS times; then the time is the calls' own on CUDA events
    (``cuda_time_ms``: the launches included), and the log says so."""
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
    ms = cuda_time_ms(fn, iters)
    log(f"no trace of {names} recorded every kernel in {TRACE_ATTEMPTS} attempts: {ms * 1e3:.1f} us a call on CUDA "
        "events, the launches included")
    return ms


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


# float32 K1 and K2 against the float64 product of the same chain (the plain
# versions on float64 inputs, ops.fused_block): on each product output (K1's
# e2; K2's de, dh, dz2, dz3) the kernel's largest error at most F64_RATIO
# times the plain float32 version's on the same inputs.  The aggregate's
# sums are not the chain: the kernel sums a long segment in edge order, the
# plain version in PyTorch's order (2.0x the plain version's error on HGN
# plate's up set, PERF.md).
F64_RATIO = 4.0


def hold_to_f64(tag, named):
    """``named``: ``{output: (kernel, plain, float64)}``.  Returns ``{output:
    (kernel error, plain error)}`` (largest absolute errors against float64)
    and raises where the kernel's passes F64_RATIO times the plain's."""
    out = {}
    for name, (got, plain, exact) in named.items():
        g = float((got.double() - exact.double()).abs().max())
        p = float((plain.double() - exact.double()).abs().max())
        out[name] = (g, p)
        if not g <= F64_RATIO * p:
            raise AssertionError(f"{tag} {name}: error against float64 {g:.3g}, more than {F64_RATIO} x the plain "
                                 f"version's {p:.3g}")
    return out


def f64_text(errs):
    return ", ".join(f"{k} {g:.3g} (plain {p:.3g})" for k, (g, p) in errs.items())


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



@contextlib.contextmanager
def fixed_scatter_order():
    """PyTorch's deterministic algorithms while the block runs (its
    scatter-adds sum in a fixed order; an operation that has no such form
    raises), then the setting as it was."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


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
    # B = 15 and 32: the task loop's last batch of 57 frames and its n-step chunk
    cases = [("bfloat16", ONE_STEP_FRAMES), ("float32", ONE_STEP_FRAMES), ("bfloat16", 1),
             ("bfloat16", TASK_LAST_BATCH), ("bfloat16", TASK_N_STEP_CHUNK)]
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


def compare_bwd(tag, dtype_name, got, want):
    """K2/K3 outputs against their plain versions' (BWD_TOL): de, dh, dz2,
    dz3, dsp, drp elementwise; dpar rows by relative L2.  Returns the largest
    error of de, dh, dz2, dz3."""
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
        err2 = compare_bwd(f"K2 {tag}", dtype_name, out2[:4] + out2[6:], ref2[:4] + ref2[6:])
        err3 = compare_bwd(f"K3 {tag}", dtype_name, out3, ref3)
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
    # one frame: about 150 work items for two teams a CTA on ceil(150 / 2)
    # CTAs; and the task loop's last batch of 57 frames
    for B in (1, TASK_LAST_BATCH):
        x, topo, plan, fwd, de2, drhs = setup("bfloat16", B, snd, rcv)
        check_both(f"B={B}", "bfloat16", x, topo, plan, fwd, de2, drhs)
        log(f"K2/K3 B={B}: ok")

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
HALO_TIMED = 20  # halo forwards timed per path
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
        # the same forward again: every rank's output the same bit for bit
        # (K1 raw, K6 and K7 fold in a fixed order; the unfused sets' local
        # partials sum through each shard's fixed-order sums)
        again = fwd(state_card, rank_graphs, all_ranks=True)
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            raise AssertionError(f"halo forward ({path}): a second forward differs from the first")
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
            f"of {E_rank} edges: {counts[kernel]} {kernel} ({blocks} per rank); a second forward bit for bit "
            f"on every rank; {ms:.2f} ms per forward "
            f"(host clock, {HALO_TIMED} calls) vs single-device forward B=1 {single_ms:.2f} ms; max err "
            f"ranks {errs['ranks']:.3g}, vs single-device {errs['single_card']:.3g}, vs CPU {errs['cpu']:.3g} "
            f"of max {scale:.3g} [{card}]"
        )
    return launches, timings


# The sharded train step (phase_spmd): flag MGN-15MP trained over a data x
# graph rank group on the one card, each group with the frames the contract
# names: (data, graph), K7's overlap bands (None: K1 raw + the plain
# all-reduce), frames per step.
SPMD_GROUPS = (((2, 2), None, 16), ((1, 4), HALO_BANDS, 8))
SPMD_STEPS = (1, 3)  # warm-up and timed sharded steps per group
# The sharded step against the single-device step on the card, same state
# and noise, both on the card (the aggregates sum the ranks' partials in
# another order; in bf16 a rounding may go the other way and pass through 15
# blocks): loss relative error and each gradient's relative L2.  bf16: set
# from this phase's own readings on an H100 (loss 1.05e-5 and 4.08e-6,
# worst gradient 3.16e-3 on 2 x 2 and 6.25e-3 on 1 x 4), about 3x the
# larger; the bf16 2 x 2 run also holds two planted faults: one graph rank's
# shard losing its K2 output (dsp, drp, de and its weight gradients), which
# must miss the limit, and the local-degree control (each shard's own
# in-degree in the mean cotangent, the JAX package's sharded backward),
# whose reading is logged.  float32: TRAIN_TOL's (reading 1.46e-4 on 1 x 4);
# both groups run it.  On 1 x 4 the local-degree control must miss it: with
# 256-edge chunks dealt round-robin every chunk boundary splits a receiver's
# edges over two ranks.  On 2 x 2 the two contiguous slices of the 40x40
# flag's 9,282 receiver-sorted edges meet between receivers 799 and 800, so
# no receiver's edges are split and the control's gradients are the sound
# run's (9.5e-5 on an H100): its reading is logged, and the lost shard
# above is that layout's planted fault.
SPMD_TOL = {"float32": TRAIN_TOL["float32"], "bfloat16": (1e-4, 2e-2)}
SPMD_WATCHDOG_S = 300  # the phase fails (traceback of every thread, exit 1) past this


@contextlib.contextmanager
def lost_shard_grads(graph):
    """A planted fault for the sharded step: the K2 outputs of every data
    row's last graph rank's shard (``de``, ``dsp``, ``drp`` and its weight
    gradients) come back as zeros, as if that shard's backward were lost."""
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    kept, calls = fb._edge_block_grads, [0]

    def lost(*args, **kwargs):
        out = kept(*args, **kwargs)
        calls[0] += 1
        return tuple(t.new_zeros(t.shape) for t in out) if calls[0] % graph == 0 else out

    fb._edge_block_grads = lost
    try:
        yield
    finally:
        fb._edge_block_grads = kept


def phase_spmd(card, peaks, seed, profile_dir=None):
    """Train flag MGN-15MP (configs/flag_full_scale.yaml, RMP off) through
    ``parallel.sharding.make_spmd_train_step`` on a 2 x 2 group (K1 raw +
    the plain all-reduce forward, K2 backward) and a 1 x 4 group with
    overlap bands (batched K7 forward, K2 backward), all ranks on the one
    card; the launches counted in advance; loss and gradients against the
    single-device step on the card; two runs bit for bit; step ms and
    edges/s; planted faults that must miss the limits (a lost shard's K2
    output in bf16 on 2 x 2, the local-degree control in float32 on 1 x 4;
    the control's readings on the other runs logged).  Each new kernel mode against its plain version: K1 raw at
    B = 8 per shard, K2 at the global degree on both layouts, batched K7,
    K6 and K7 on the sub-rings of a 2 x 2 group; the 2-D halo forward (ring:
    K6, overlap: K7) on every rank against the single-device forward.  A
    watchdog ends the run (exit 1, every thread's traceback) if the phase
    hangs.  With ``profile_dir``, one traced sharded step (loss and
    backward) of each group and the single-device step beside it."""
    import dataclasses
    import faulthandler

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import (
        fused_edge_block_overlap,
        fused_edge_block_overlap_reference,
    )
    from hyper_graph_nets_tpu_torch.ops.ring import (
        ring_all_reduce_segments,
        ring_all_reduce_segments_reference,
    )
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, shard_graph, split_graph
    from hyper_graph_nets_tpu_torch.parallel.sharding import (
        RankPlans,
        make_spmd_train_step,
        shard_frames,
        shard_topology,
    )
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    faulthandler.dump_traceback_later(SPMD_WATCHDOG_S, exit=True)
    log(f"spmd: watchdog armed ({SPMD_WATCHDOG_S} s)")
    t_phase = time.perf_counter()
    B_max = max(b for _, _, b in SPMD_GROUPS)
    traj = add_targets(flag_trajectory(num_steps=B_max + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    every = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    group_of = lambda shape: RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))

    def setup(**model_cfg):
        config = main_config(**model_cfg)
        config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
        model = get_model(config)
        trainer = Trainer(model, config)
        state = model.init_state(torch.Generator().manual_seed(seed))
        with torch.no_grad():  # normalizers over the trajectory, as a run's would be
            topo_cpu = model.topology_from_trajectory(traj, device="cpu")
            _, _, state = model.make_graph(state, topo_cpu, every, True)
            _, state = model.get_target(state, every, True)
        return model, trainer, state, model.topology_from_trajectory(traj, device="cuda")

    def grads_of(params):
        return {n: p.grad.detach().clone() for n, p in params.named_parameters()}

    def compare(tag, dtype_name, loss, grads, ref_loss, ref_grads):
        loss_tol, grad_tol = SPMD_TOL[dtype_name]
        loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        worst = max((rel_l2(grads[n], ref_grads[n]), n) for n in ref_grads)
        ok = loss_err <= loss_tol and worst[0] <= grad_tol
        return ok, loss_err, worst

    def local_degree(st):  # the control: every shard's plan without the global degree
        return st._replace(plan=RankPlans(tuple(dataclasses.replace(p, degree=None) for p in st.plan.plans)))

    def readings(found):
        return {k: dict(passed=v[0], loss_rel_err=v[1], worst_grad_rel_l2=v[2][0], worst_grad=v[2][1])
                for k, v in found.items()}

    launches, timings, rows = dict.fromkeys(read_counts(), 0), {}, {}
    model, trainer, state, topo = setup()
    cfg = model.gnn_config
    check_mgn15(cfg)
    blocks, N, L = cfg.message_passing_steps, 1600, L_MAIN
    E = int(topo.senders.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)

    for shape, bands, B in SPMD_GROUPS:
        group = group_of(shape)
        tag = f"{shape[0]}x{shape[1]}" + (f" overlap {bands}" if bands else "")
        kernel = "K7" if bands else "K1"
        frames = {k: v[:B].cuda() for k, v in every.items()}
        normal = torch.randn(frames["world_pos"].shape, generator=gen, device="cuda")
        stopo = shard_topology(topo, group, overlap_bands=bands)
        E_pad = int(stopo.senders.shape[0])
        ts = trainer.init_train_state(state=state)
        ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal)
        ref_grads = grads_of(ts.model.params)
        step = make_spmd_train_step(trainer, stopo, group)

        # the main path: every count set to 0 just before, read just after
        reset_counts()
        loss, norms = step.loss_and_grads(ts, frames, normal=normal)
        group.check()
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want[kernel] = want["K2"] = blocks * group.n
        if counts != want:
            raise AssertionError(f"sharded step {tag}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        grads = grads_of(ts.model.params)
        ok, loss_err, worst = compare(tag, "bfloat16", loss, grads, ref_loss, ref_grads)
        if not ok or not np.isfinite(float(loss)):
            raise AssertionError(f"sharded step {tag} vs single-device: loss rel {loss_err:.3g}, worst "
                                 f"gradient {worst}, limits {SPMD_TOL['bfloat16']}")
        loss2, norms2 = step.loss_and_grads(ts, frames, normal=normal)
        grads2 = grads_of(ts.model.params)
        if not (torch.equal(loss, loss2) and all(torch.equal(grads[n], grads2[n]) for n in grads)
                and all(torch.equal(getattr(norms[k], f), getattr(norms2[k], f)) for k in norms
                        for f in ("acc_count", "acc_sum", "acc_sum_squared"))):
            raise AssertionError(f"sharded step {tag}: a second run differs from the first")
        if not bands:  # the planted faults, against the bf16 limit
            planted = {}
            for fault, st, ctx in (("lost shard", stopo, lost_shard_grads(shape[1])),
                                   ("local degree", local_degree(stopo), contextlib.nullcontext())):
                with ctx:
                    floss, _ = make_spmd_train_step(trainer, st, group).loss_and_grads(ts, frames, normal=normal)
                planted[fault] = compare(fault, "bfloat16", floss, grads_of(ts.model.params), ref_loss, ref_grads)
            group.check()
            if planted["lost shard"][0]:
                raise AssertionError(f"sharded step {tag}: a lost shard's K2 output passed the bf16 limits "
                                     f"{SPMD_TOL['bfloat16']}: {planted['lost shard']}")
            timings[f"{tag} planted (bf16)"] = readings(planted)
            log(f"sharded step {tag} bf16 planted faults vs single-device: a lost shard's K2 output worst "
                f"gradient rel L2 {planted['lost shard'][2][0]:.3g} ({planted['lost shard'][2][1]}) misses the "
                f"limit {SPMD_TOL['bfloat16'][1]}; the local-degree control "
                f"{planted['local degree'][2][0]:.3g} ({planted['local degree'][2][1]}) [{card}]")

        # step time: the full step (Adam included) on a state of its own
        tst = trainer.init_train_state(state=state)
        for _ in range(SPMD_STEPS[0]):
            tst, _ = step(tst, frames, normal=normal)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPMD_STEPS[1]):
            tst, last = step(tst, frames, normal=normal)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SPMD_STEPS[1]
        group.check()
        tsd = trainer.init_train_state(state=state)
        for _ in range(SPMD_STEPS[0]):
            tsd, _ = trainer.train_step(tsd, topo, frames, normal=normal)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPMD_STEPS[1]):
            tsd, _ = trainer.train_step(tsd, topo, frames, normal=normal)
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0) / SPMD_STEPS[1]
        if not np.isfinite(float(last)):
            raise AssertionError(f"sharded step {tag}: loss {float(last)} after {sum(SPMD_STEPS)} steps")
        if profile_dir:
            device_profile(lambda: step.loss_and_grads(ts, frames, normal=normal), card, profile_dir,
                           f"spmd_{shape[0]}x{shape[1]}")
            device_profile(lambda: trainer.loss_and_grads(ts, topo, frames, normal=normal), card, profile_dir,
                           f"single_device_B{B}")
        timings[tag] = dict(
            B=B, ranks=group.n, edges=E, edges_padded=E_pad, edges_per_rank=E_pad // shape[1],
            step_ms=ms, edges_per_s=B * E / (ms / 1e3), padded_edges_per_s=B * E_pad / (ms / 1e3),
            single_device_step_ms=single_ms, loss_rel_err=loss_err, worst_grad_rel_l2=worst[0],
            worst_grad=worst[1], launches=counts,
        )
        log(
            f"sharded step {tag} (flag MGN-15MP bf16, 40x40, B={B}, {group.n} ranks on one card, "
            f"{E_pad // shape[1]} edges per graph rank): {counts[kernel]} {kernel} + {counts['K2']} K2 "
            f"({blocks} blocks x {group.n} ranks); vs single-device step: loss rel {loss_err:.3g}, worst "
            f"gradient rel L2 {worst[0]:.3g} ({worst[1]}); a second run bit for bit; {ms:.1f} ms per step "
            f"(host clock, Adam included; single-device step at B={B} {single_ms:.1f} ms), "
            f"{B * E / (ms / 1e3):.4g} edges/s ({B * E_pad / (ms / 1e3):.4g} padded) [{card}]"
        )

        # the kernels' new modes at this group's shapes, against their plain versions
        with torch.no_grad():
            graph, _, _ = model.make_graph(ts.model, stopo, shard_frames(frames, group)[0], False)
        g0 = shard_graph(graph, group, 0)
        es = g0.edge_sets["mesh_edges"]
        Bk, E_shard = B // shape[0], es.num_edges
        plan = es.plan
        found, x = shard_kernel_rows(f"{tag} shard", peaks, gen, es.senders.cpu().numpy(), es.receivers.cpu().numpy(),
                                     es.mask.cpu().numpy(), plan, N, Bk, seed + 12)
        if torch.equal(plan.degree.cuda(), torch.bincount(x["receivers"][x["mask"] > 0].long(), minlength=N).float()):
            raise AssertionError(f"K2 global degree {tag}: the shard's degree equals the global one: no test")
        rows[f"K2 {tag}"] = found["K2"]
        if not bands:
            rows["K1 raw"] = found["K1 raw"]
        k1b = k1_bound_ms("bfloat16", Bk, E_shard, N, L, peaks)
        if bands:  # batched K7 on every rank's shard of this group
            shards = []
            for r in range(group.n):
                er = shard_graph(graph, group, r).edge_sets["mesh_edges"]
                shards.append(dict(
                    e=torch.randn(Bk, er.num_edges, L, generator=gen, device="cuda").to(torch.bfloat16),
                    sp=x["sp"], rp=x["rp"], weights=x["weights"], senders=er.senders, receivers=er.receivers,
                    mask=er.mask, plan=er.plan,
                ))
            run7 = lambda: fused_edge_block_overlap(shards, N, group, bands)
            got7 = run7()
            group.check()
            want7 = fused_edge_block_overlap_reference(shards, N, group)
            err7 = 0.0
            for r in range(group.n):
                solo = fb.fused_edge_block_fwd(shards[r]["e"], x["sp"], x["rp"], x["weights"], shards[r]["senders"],
                                               shards[r]["receivers"], shards[r]["mask"], N, shards[r]["plan"])
                if not torch.equal(got7[r][0], solo[0]):
                    raise AssertionError(f"batched K7 rank {r}: e2 differs from K1's on the same shard")
                err7 = max(err7, check_close(f"batched K7 rank {r} agg", got7[r][1], want7[r][1],
                                             *TOL["bfloat16"]["agg"]))
            rows["K7 batched"] = dict(
                max_abs_err=err7, ms=group_time_ms(group, run7, iters=20),
                plain_ms=cuda_time_ms(lambda: fused_edge_block_overlap_reference(shards, N, group), iters=3),
                bound_ms=group.n * k1b[0], bound_by=k1b[1],
                shape=f"bf16 B={Bk} {group.n} ranks of E={E_shard}, {bands} bands, one ring pass a frame",
            )

    # float32 on both groups, each with the local-degree control
    fmodel, ftrainer, fstate, ftopo = setup(compute_dtype=None)
    for shape, bands, B in SPMD_GROUPS:
        group = group_of(shape)
        tag = f"{shape[0]}x{shape[1]}" + (f" overlap {bands}" if bands else "")
        frames = {k: v[:B].cuda() for k, v in every.items()}
        normal = torch.randn(frames["world_pos"].shape, generator=gen, device="cuda")
        fts = ftrainer.init_train_state(state=fstate)
        ref_loss, _ = ftrainer.loss_and_grads(fts, ftopo, frames, normal=normal)
        ref_grads = grads_of(fts.model.params)
        stopo = shard_topology(ftopo, group, overlap_bands=bands)
        found = {}
        for name, st in (("global degree", stopo), ("local degree (control)", local_degree(stopo))):
            loss, _ = make_spmd_train_step(ftrainer, st, group).loss_and_grads(fts, frames, normal=normal)
            found[name] = compare(name, "float32", loss, grads_of(fts.model.params), ref_loss, ref_grads)
        group.check()
        if not found["global degree"][0]:
            raise AssertionError(f"float32 sharded step {tag} vs single-device: {found['global degree']}, "
                                 f"limits {SPMD_TOL['float32']}")
        if bands and found["local degree (control)"][0]:
            raise AssertionError(f"float32 sharded step {tag}: the local-degree control passed the limits: "
                                 f"{found['local degree (control)']}")
        timings[f"{tag} float32 degree"] = readings(found)
        log(f"float32 sharded step {tag} vs single-device: loss rel {found['global degree'][1]:.3g}, worst "
            f"gradient rel L2 {found['global degree'][2][0]:.3g}; the local-degree control "
            f"{found['local degree (control)'][2][0]:.3g} ({found['local degree (control)'][2][1]}) "
            f"{'misses' if not found['local degree (control)'][0] else 'within'} the limit "
            f"{SPMD_TOL['float32'][1]} [{card}]")

    # the 2-D halo forward and K6/K7 on the sub-rings of a 2 x 2 group
    group = group_of((2, 2))
    frame = {k: v[0].cuda() for k, v in every.items()}
    for path, agg_vjp, ring, overlap, kernel in (("ring", "xla", True, False, "K6"),
                                                 ("overlap", "fused", False, True, "K7")):
        hmodel = get_model(main_config(agg_vjp=agg_vjp))
        hstate = state.to("cuda")
        htopo = hmodel.topology_from_trajectory(traj, device="cuda")
        hst = shard_topology(htopo, group, overlap_bands=HALO_BANDS if overlap else None)
        with torch.no_grad():
            graph, _, _ = hmodel.make_graph(hstate, hst, frame, False)
            single_graph, _, _ = hmodel.make_graph(hstate, htopo, frame, False)
            single = hmodel.forward(hstate, single_graph)
        rank_graphs = split_graph(graph, group)
        fwd = make_halo_forward(hmodel, group, ring=ring, overlap=overlap)
        reset_counts()
        outs = fwd(hstate, rank_graphs, all_ranks=True)
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want[kernel] = blocks * group.n
        if counts != want:
            raise AssertionError(f"2-D halo forward ({path}): launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        scale = float(single.abs().max())
        err = max(float((o - single).abs().max()) for o in outs)
        if err > SERVE_TOL["net_out"] * scale or not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"2-D halo forward ({path}): max err {err} of max {scale}")
        timings[f"halo 2x2 {path}"] = dict(launches=counts[kernel], max_err_vs_single=err, out_scale=scale)
        log(f"2-D halo forward ({path}) 2 x 2 ranks: {counts[kernel]} {kernel}; every rank vs single-device "
            f"max err {err:.3g} of max {scale:.3g} [{card}]")
        es = [g.edge_sets["mesh_edges"] for g in rank_graphs]
        if overlap:  # K7 on the sub-rings: each data row's two graph ranks ring on their own
            xs = k1_inputs(torch.bfloat16, 1, es[0].senders.cpu().numpy(), es[0].receivers.cpu().numpy(), N, L,
                           torch.Generator().manual_seed(seed + 13), "cuda")
            shards = [dict(e=torch.randn(e.num_edges, L, generator=gen, device="cuda").to(torch.bfloat16),
                           sp=xs["sp"][0], rp=xs["rp"][0], weights=xs["weights"], senders=e.senders,
                           receivers=e.receivers, mask=e.mask, plan=e.plan) for e in es]
            run = lambda: fused_edge_block_overlap(shards, N, group, HALO_BANDS)
            got = run()
            group.check()
            want7 = fused_edge_block_overlap_reference(shards, N, group)
            err7 = max(check_close(f"K7 sub-ring rank {r}", got[r][1], want7[r][1], *TOL["bfloat16"]["agg"])
                       for r in range(group.n))
            k1b = k1_bound_ms("bfloat16", 1, es[0].num_edges, N, L, peaks)
            rows["K7 sub-ring"] = dict(
                max_abs_err=err7, ms=group_time_ms(group, run, iters=20),
                plain_ms=cuda_time_ms(lambda: fused_edge_block_overlap_reference(shards, N, group), iters=3),
                bound_ms=group.n * k1b[0], bound_by=k1b[1],
                shape=f"bf16 B=1, 2 x 2 ranks of E={es[0].num_edges}, rings along graph",
            )
        else:  # K6 on the sub-rings, bit for bit
            segments = [(0, N, "sum"), (N, 2 * N, "sum"), (2 * N, 3 * N, "max"), (3 * N, 4 * N, "min")]
            xs = [torch.randn(4 * N, L, generator=gen, device="cuda") for _ in range(group.n)]
            run = lambda: ring_all_reduce_segments(xs, segments, group)
            got = run()
            group.check()
            want6 = ring_all_reduce_segments_reference(xs, segments, group)
            for r in range(group.n):
                if not torch.equal(got[r], want6[r]):
                    raise AssertionError(f"K6 sub-ring rank {r}: differs from its plain version")
            rows["K6 sub-ring"] = dict(
                max_abs_err=0.0, ms=group_time_ms(group, run, iters=50),
                plain_ms=cuda_time_ms(lambda: ring_all_reduce_segments_reference(xs, segments, group), iters=5),
                **{k: v for k, v in ring_bounds_ms(group.n, 4 * N * L * 4, peaks).items()
                   if k in ("bound_ms", "bound_by")},
                shape=f"float32 [{4 * N}, {L}] per rank, 2 x 2 ranks, sub-rings of 2 along graph",
            )
    for name, r in rows.items():
        log(f"{name} ({r['shape']}): {r['ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
            f"plain {r['plain_ms']:.3f} ms, max abs err {r['max_abs_err']:.3g} [{card}]")
    faulthandler.cancel_dump_traceback_later()
    log(f"spmd: {time.perf_counter() - t_phase:.1f} s, watchdog disarmed")
    return launches, timings, rows


# The sharded step with an expansion (phase_spmd_rmp): configs/flag_full_scale.yaml
# as shipped (RMP: spectral into 16 clusters, connector hyper, 15
# hierarchical blocks, hyper noise 0.005, bf16, fused remat) over the groups
# of SPMD_GROUPS, the same file with the Ricci balancer on the 2 x 2 group
# (bf16, and float32 with the degree control), the sorted path at reduced
# depth, and the sharded forward.  The sharded step against the
# single-device step on the card, same state, static and noise: loss
# relative error and each gradient's relative L2, by group: ``grad`` the
# mesh tier (encoders, decoder, mesh node and edge models), ``tier_grad``
# RMP_TIER's cluster-tier tensors (fed by the B x 16 hyper rows),
# ``balance_grad`` the balance set's encoder and edge models (fed by its up
# to 300 edges).  Set from this phase's readings on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md section 6, the sharded step with an expansion; the steps
# are bit for bit, so a reading repeats on every run of this code with the
# same draws): bf16 about 3x the worst over every run and draw, loss 1.55e-5
# (the sorted path), mesh tier 9.1e-3, cluster tier 2.9e-2, balance set
# 6.8e-2.  Float32 (the balancer run, over two noise draws) between the
# sound runs' largest reading and the degree control's smallest: loss
# 1.2e-7 (the control 1.2e-7: its forward is the same), mesh tier 1.1e-4
# against 6.4e-4, cluster tier 2.6e-4, balance set 1.0e-3 against 8.8e-3:
# the control (every mesh plan's in-degree from the unmasked topology) must
# miss on both draws.  The bf16 2 x 2 RMP run carries the lost up-set
# partials (loss 3.0e-2), which must miss too.
SPMD_RMP_TOL = {
    "bfloat16": {"loss": 5e-5, "grad": 2.5e-2, "tier_grad": 0.09, "balance_grad": 0.2},
    "float32": {"loss": 1e-6, "grad": 3.5e-4, "tier_grad": 1e-3, "balance_grad": 6e-3},
}
SPMD_RMP_STEPS = 1  # timed sharded and single-device steps per group, after the checked runs (cut from 2 for the time limit)
SPMD_SORTED_BLOCKS = 5  # the sorted path's depth: cut from 15 for the script's time limit


@contextlib.contextmanager
def lost_up_partials(group, num_nodes, up_edges):
    """A planted fault for the sharded RMP step: graph rank 1's local
    partials of the up set (intra_cluster_to_cluster: its ``up_edges /
    graph`` edges per rank all name hyper rows) come back empty in the
    forward (no sum, no count, no max or min), as if that shard's messages
    to the cluster tier were lost."""
    import torch

    from hyper_graph_nets_tpu_torch.core import segment_ops

    kept, per = segment_ops.pna_partials, up_edges // group.shape["graph"]

    def lost(data, ids, n, mask=None, sums=None):
        raw = kept(data, ids, n, mask, sums)
        if (group.axis_index(group.rank(), "graph") == 1 and ids.numel() == per
                and int(ids.min()) >= num_nodes):
            F = data.shape[-1]
            raw = torch.cat([torch.zeros_like(raw[..., : 2 * F]), torch.full_like(raw[..., 2 * F : 3 * F], -1e30),
                             torch.full_like(raw[..., 3 * F :], 1e30)], dim=-1)
        return raw

    segment_ops.pna_partials = lost
    try:
        yield
    finally:
        segment_ops.pna_partials = kept


def tiered_errors(loss, grads, ref_loss, ref_grads):
    """Loss relative error and the worst gradient relative L2 of the mesh
    tier, the cluster tier (RMP_TIER) and the balance set, each with its
    tensor's name."""
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    group = lambda n: ("tier_grad" if any(p in n for p in RMP_TIER) else
                       "balance_grad" if "balance" in n else "grad")
    out = dict(loss=loss_err)
    for g in ("grad", "tier_grad", "balance_grad"):
        out[g] = max(((rel_l2(grads[n], ref_grads[n]), n) for n in ref_grads if group(n) == g), default=(0.0, None))
    return out


def tiered_ok(errs, dtype_name="bfloat16"):
    tol = SPMD_RMP_TOL[dtype_name]
    return errs["loss"] <= tol["loss"] and all(errs[g][0] <= tol[g] for g in ("grad", "tier_grad", "balance_grad"))


def tiered_text(errs):
    text = (f"loss rel {errs['loss']:.3g}, worst mesh-tier gradient rel L2 {errs['grad'][0]:.3g} "
            f"({errs['grad'][1]}), worst cluster-tier {errs['tier_grad'][0]:.3g} ({errs['tier_grad'][1]})")
    if errs["balance_grad"][1] is not None:
        text += f", worst balance-set {errs['balance_grad'][0]:.3g} ({errs['balance_grad'][1]})"
    return text


def shard_kernel_rows(tag, peaks, gen, snd, rcv, mask, plan, rows, Bk, seed, dtype_name="bfloat16"):
    """K1 raw and K2 (at the plan's degree) on one rank's shard over
    ``rows`` node rows, with ``mask`` (padding and interior masks), in
    ``dtype_name``, against their plain versions: ``{"K1 raw": row, "K2":
    row}``."""
    import torch

    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    L, dtype = L_MAIN, getattr(torch, dtype_name)
    label = "bf16" if dtype_name == "bfloat16" else dtype_name
    x = k1_inputs(dtype, Bk, snd, rcv, rows, L, torch.Generator().manual_seed(seed), "cuda", mask=mask)
    topo_args = (x["senders"], x["receivers"], x["mask"], rows)
    E = len(snd)
    run1 = lambda: fb.fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *topo_args, plan, raw=True)
    got = run1()
    want = fb.fused_edge_block_reference(x["e"], x["sp"], x["rp"], x["weights"], *topo_args, raw=True)
    err = max(check_close(f"K1 raw {tag} e2", got[0], want[0], *TOL[dtype_name]["e2"]),
              check_close(f"K1 raw {tag} agg", got[1], want[1], *TOL[dtype_name]["agg"]))
    k1b = k1_bound_ms(dtype_name, Bk, E, rows, L, peaks)
    out = {"K1 raw": dict(
        max_abs_err=err, ms=kernel_device_ms(run1, iters=20, names="fused_block_fwd_kernel"),
        plain_ms=cuda_time_ms(lambda: fb.fused_edge_block_reference(
            x["e"], x["sp"], x["rp"], x["weights"], *topo_args, raw=True), iters=5),
        bound_ms=k1b[0], bound_by=k1b[1],
        shape=f"{label} B={Bk} E={E} rows={rows}, {int((mask == 0).sum())} edges masked ({tag})")}
    e2, agg = fb.fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *topo_args, plan)
    dagg = torch.randn(agg.shape, generator=gen, device="cuda")
    de2 = torch.randn(x["e"].shape, generator=gen, device="cuda").to(dtype)
    drhs = fb.agg_cotangent_rhs(agg, dagg, x["receivers"], x["mask"], rows, plan.degree)
    run2 = lambda: fb.fused_edge_block_bwd(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo_args, plan=plan)
    got2 = run2()
    fwd_vals = fb.fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *topo_args, plan, save_streams=True)
    want2 = fb.fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo_args,
                                              forward=(fwd_vals[0], fwd_vals[2], fwd_vals[3]))
    order = lambda o: (o[0], o[1], o[2], o[3], o[6], o[7], o[8])
    err2 = compare_bwd(f"K2 {tag}", dtype_name, order(got2), order(want2))
    k2b = bwd_bound_ms(dtype_name, Bk, E, rows, L, peaks, False)
    out["K2"] = dict(
        max_abs_err=err2, ms=kernel_device_ms(run2, iters=10, names=BWD_KERNELS),
        plain_ms=cuda_time_ms(lambda: fb.fused_edge_block_bwd_reference(
            x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo_args), iters=3),
        bound_ms=k2b[0], bound_by=k2b[1], shape=out["K1 raw"]["shape"] + ", global degree")
    return out, x


def k7_group_row(tag, peaks, gen, group, stopo, plans, masks, rows, Bk, bands, x, dtype_name="bfloat16"):
    """K7 over every rank's round-robin shard of ``stopo`` (``masks[k]``
    each, ``plans[k]`` each, over ``rows`` rows, ``Bk`` frames; the node
    rows and weights of ``x``) against its plain version: each rank's e2
    K1's bit for bit on the same shard, the aggregate K1 raw's with the
    plain all-reduce and the finalize.  Timed per call of every rank."""
    import torch

    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import (
        fused_edge_block_overlap,
        fused_edge_block_overlap_reference,
    )

    L, per, dtype = L_MAIN, stopo.layout.per, getattr(torch, dtype_name)
    shard_arr = lambda t, k: torch.as_tensor(t[k * per : (k + 1) * per].cpu().numpy()).cuda()
    shards = [dict(e=torch.randn(Bk, per, L, generator=gen, device="cuda").to(dtype), sp=x["sp"], rp=x["rp"],
                   weights=x["weights"], senders=shard_arr(stopo.senders, k), receivers=shard_arr(stopo.receivers, k),
                   mask=torch.as_tensor(masks[k]).cuda(), plan=plans[k])
              for k in range(group.n)]
    run7 = lambda: fused_edge_block_overlap(shards, rows, group, bands)
    got7 = run7()
    group.check()
    want7 = fused_edge_block_overlap_reference(shards, rows, group)
    err7 = 0.0
    for k, sh in enumerate(shards):
        solo = fb.fused_edge_block_fwd(sh["e"], x["sp"], x["rp"], x["weights"], sh["senders"], sh["receivers"],
                                       sh["mask"], rows, sh["plan"])
        if not torch.equal(got7[k][0], solo[0]):
            raise AssertionError(f"K7 {tag} rank {k}: e2 differs from K1's on the same shard")
        err7 = max(err7, check_close(f"K7 {tag} rank {k} agg", got7[k][1], want7[k][1], *TOL[dtype_name]["agg"]))
    k1b = k1_bound_ms(dtype_name, Bk, per, rows, L, peaks)
    label = "bf16" if dtype_name == "bfloat16" else dtype_name
    masked = sum(int((m == 0).sum()) for m in masks)
    return dict(max_abs_err=err7, ms=group_time_ms(group, run7, iters=20),
                plain_ms=cuda_time_ms(lambda: fused_edge_block_overlap_reference(shards, rows, group), iters=3),
                bound_ms=group.n * k1b[0], bound_by=k1b[1],
                shape=f"{label} B={Bk} {group.n} ranks of E={per} over {rows} rows, {bands} bands, {masked} edges "
                      f"masked")


def sorted_joined_rows(peaks, gen, stopo, Bk):
    """K4f and K4b on one data row's joined shards as the sharded sorted
    step gives them (bf16 ``[Bk, E, L]`` over the laid-out mesh edges, the
    padding masked at the tail, interior masks as the balancer's removals
    lie) against their plain versions: ``{"K4f joined": row, "K4b joined":
    row}``."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.segment_pna import (
        pna_sorted,
        pna_sorted_bwd,
        pna_sorted_bwd_reference,
        pna_sorted_reference,
    )

    L, N, plan = L_MAIN, stopo.num_nodes, stopo.plan
    rcv = stopo.receivers
    mask = torch.as_tensor(stopo.mask.cpu().numpy() * interior_mask(rcv.cpu().numpy())).cuda()
    E = int(rcv.shape[0])
    data = torch.randn(Bk, E, L, generator=gen, device="cuda").to(torch.bfloat16)
    fwd = lambda: pna_sorted(data, rcv, mask, N, plan=plan)
    out = fwd()
    want = pna_sorted_reference(data, rcv, mask, N)
    err = check_close("K4f joined shards sum/mean", out[..., : 2 * L], want[..., : 2 * L], SORTED_TOL["bfloat16"], 1e-5)
    if not torch.equal(out[..., 2 * L :], want[..., 2 * L :]):
        raise AssertionError("K4f joined shards: max/min differ from the plain version")
    g = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    bwd = lambda: pna_sorted_bwd(g, out, data, rcv, mask, N, plan=plan)
    if not torch.equal(bwd(), pna_sorted_bwd_reference(g, out, data, rcv, mask, N)):
        raise AssertionError("K4b joined shards: differs from the plain version on K4f's output")
    shape = f"bf16 B={Bk} E={E} (2 shards joined, padding and {int((mask == 0).sum())} edges masked) N={N}"
    rows = {}
    for name, run, plain, kname, backward in (
        ("K4f joined", fwd, lambda: pna_sorted_reference(data, rcv, mask, N), "pna_fwd_kernel", False),
        ("K4b joined", bwd, lambda: pna_sorted_bwd_reference(g, out, data, rcv, mask, N), "pna_bwd_kernel", True),
    ):
        bound, bound_by = sorted_bound_ms("bfloat16", Bk, E, N, L, peaks, backward)
        rows[name] = dict(max_abs_err=err if not backward else 0.0, ms=kernel_device_ms(run, iters=20, names=kname),
                          plain_ms=cuda_time_ms(plain, iters=5), bound_ms=bound, bound_by=bound_by, shape=shape)
    return rows


def phase_spmd_rmp(card, peaks, seed, profile_dir=None):
    """Train configs/flag_full_scale.yaml as shipped (RMP) through
    ``parallel.sharding.make_spmd_train_step`` with its expansion on a 2 x 2
    group (K1 raw over the 1,616 rows + the plain all-reduce forward, K2
    backward; the tier sets unfused through the sharded aggregate) and a
    1 x 4 group with overlap bands (K7 over 1,616 rows, K2), all ranks on
    the one card: launches counted in advance, loss and gradients against
    the single-device RMP step on the card (SPMD_RMP_TOL), two runs bit for
    bit, a planted fault (graph rank 1's up-set partials lost) that must
    miss the limit, step ms and edges/s.  Then the same file with the Ricci
    balancer on 2 x 2 (SDRF with K5 in the trainer's prepare; the removed
    mesh edges interior masks on every shard; the plans' degree counting
    the kept edges, and the unmasked topology's degree as a control that
    must miss in float32, after which the laid-out static must give the
    first run's gradients bit for bit, and a second noise draw, the
    control first, within and past the limits again), the sorted path at
    SPMD_SORTED_BLOCKS blocks (K4f on each data row's joined mesh shards,
    K4b in its backward; held against their plain versions at that shape),
    and
    ``make_sharded_forward`` with RMP on 2 x 2 against the single-device
    forward.  K1 raw and K2 over 1,616 rows with interior masks, and K7
    over 1,616 rows with them, against their plain versions.  A watchdog
    ends the run if the phase hangs."""
    import faulthandler

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import (
        ShardedStatic,
        make_sharded_forward,
        make_spmd_train_step,
        shard_topology,
        with_degree,
    )
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    faulthandler.dump_traceback_later(SPMD_WATCHDOG_S, exit=True)
    log(f"spmd rmp: watchdog armed ({SPMD_WATCHDOG_S} s)")
    t_phase = time.perf_counter()
    B_max = max(b for _, _, b in SPMD_GROUPS)
    traj = add_targets(flag_trajectory(num_steps=B_max + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    every = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    frame0 = {k: v[0] for k, v in traj.items()}
    group_of = lambda shape: RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
    grads_of = lambda params: {n: p.grad.detach().clone() for n, p in params.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)

    config = rmp_config()
    model = get_model(config)
    check_rmp(model.gnn_config)
    blocks, N, L = model.gnn_config.message_passing_steps, 1600, L_MAIN
    state = rmp_state(config, traj, seed)
    trainer = Trainer(model, config)
    topo = model.topology_from_trajectory(traj, device="cuda")
    static = trainer.expansion.prepare(model, frame0, topo)
    rows = N + static[0].num_clusters
    if rows != N + RMP_CLUSTERS:
        raise AssertionError(f"rmp static: {rows - N} clusters, want {RMP_CLUSTERS}")
    E = int(topo.senders.shape[0])
    launches, timings, kernel_rows = dict.fromkeys(read_counts(), 0), {}, {}

    def draws(B):
        frames = {k: v[:B].cuda() for k, v in every.items()}
        normal = torch.randn(frames["world_pos"].shape, generator=gen, device="cuda")
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen, device="cuda")
        return frames, normal, hyper

    def counted(tag, fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        full = dict.fromkeys(counts, 0)
        full.update(want)
        if counts != full:
            raise AssertionError(f"{tag}: launches {counts}, want {full}")
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    for shape, bands, B in SPMD_GROUPS:
        group = group_of(shape)
        tag = f"rmp {shape[0]}x{shape[1]}" + (f" overlap {bands}" if bands else "")
        kernel = "K7" if bands else "K1"
        frames, normal, hyper = draws(B)
        ts = trainer.init_train_state(state=state)
        ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        ref_grads = grads_of(ts.model.params)
        stopo = shard_topology(topo, group, overlap_bands=bands)
        step = make_spmd_train_step(trainer, stopo, group)
        t0 = time.perf_counter()
        sstatic = step.laid_out(static)
        layout_s = time.perf_counter() - t0
        run = lambda: step.loss_and_grads(ts, frames, normal=normal, static=static, hyper_normal=hyper)

        # the main path: every count set to 0 just before, read just after
        (loss, norms), counts = counted(f"sharded step {tag}", run, {kernel: blocks * group.n, "K2": blocks * group.n})
        group.check()
        grads = grads_of(ts.model.params)
        errs = tiered_errors(loss, grads, ref_loss, ref_grads)
        if not tiered_ok(errs) or not np.isfinite(float(loss)):
            raise AssertionError(f"sharded step {tag} vs single-device: {tiered_text(errs)}; limits "
                                 f"{SPMD_RMP_TOL['bfloat16']}")
        loss2, norms2 = run()
        grads2 = grads_of(ts.model.params)
        if not (torch.equal(loss, loss2) and all(torch.equal(grads[n], grads2[n]) for n in grads)
                and all(torch.equal(getattr(norms[k], f), getattr(norms2[k], f)) for k in norms
                        for f in ("acc_count", "acc_sum", "acc_sum_squared"))):
            raise AssertionError(f"sharded step {tag}: a second run differs from the first")
        planted = None
        if not bands:  # one graph rank's up-set partials lost: must miss the limits
            with lost_up_partials(group, N, int(sstatic.members[0].up_senders.shape[0])):
                floss, _ = run()
            planted = tiered_errors(floss, grads_of(ts.model.params), ref_loss, ref_grads)
            if tiered_ok(planted):
                raise AssertionError(f"sharded step {tag}: lost up-set partials passed the limits: "
                                     f"{tiered_text(planted)}")
            log(f"sharded step {tag} planted fault (graph rank 1's up-set partials lost): {tiered_text(planted)}, "
                f"misses the limits {SPMD_RMP_TOL['bfloat16']} [{card}]")
        group.check()

        # step time: the full step (Adam included) beside the single-device step, each warm
        tst = trainer.init_train_state(state=state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPMD_RMP_STEPS):
            tst, last = step(tst, frames, normal=normal, static=static, hyper_normal=hyper)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SPMD_RMP_STEPS
        group.check()
        tsd = trainer.init_train_state(state=state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPMD_RMP_STEPS):
            tsd, _ = trainer.train_step(tsd, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0) / SPMD_RMP_STEPS
        if not np.isfinite(float(last)):
            raise AssertionError(f"sharded step {tag}: loss {float(last)} after the timed steps")
        if profile_dir:
            device_profile(run, card, profile_dir, f"spmd_rmp_{shape[0]}x{shape[1]}")
        E_pad = int(stopo.senders.shape[0])
        timings[tag] = dict(
            B=B, ranks=group.n, edges=E, edges_padded=E_pad, rows=rows, step_ms=ms,
            edges_per_s=B * E / (ms / 1e3), single_device_step_ms=single_ms, layout_s=layout_s,
            errors=errs, planted=planted, launches=counts,
        )
        log(f"sharded step {tag} (flag HGN-15MP bf16 as shipped, 40x40, B={B}, {group.n} ranks on one card, "
            f"{E_pad // shape[1]} mesh edges per graph rank over {rows} rows): {counts[kernel]} {kernel} + "
            f"{counts['K2']} K2; vs single-device step: {tiered_text(errs)}; a second run bit for bit; "
            f"{ms:.1f} ms per step (host clock, Adam included; single-device step {single_ms:.1f} ms), "
            f"{B * E / (ms / 1e3):.4g} edges/s; static laid out in {layout_s:.3f} s [{card}]")

        # the kernels at this group's shapes, with interior masks (the balancer's removals' pattern)
        Bk = B // shape[0]
        per = stopo.layout.per
        plan = sstatic.members[0].mesh_plan.plans[0]
        shard_arr = lambda t, k: t[k * per : (k + 1) * per].cpu().numpy()
        masks = [shard_arr(stopo.mask, k) * interior_mask(shard_arr(stopo.receivers, k)) for k in range(shape[1])]
        found, x = shard_kernel_rows(tag, peaks, gen, shard_arr(stopo.senders, 0), shard_arr(stopo.receivers, 0),
                                     masks[0], plan, rows, Bk, seed + 22)
        kernel_rows[f"K2 {tag}"] = found["K2"]
        if not bands:
            kernel_rows[f"K1 raw {tag}"] = found["K1 raw"]
        else:  # K7 over every rank's shard of this group, interior masks on each
            kernel_rows[f"K7 {tag}"] = k7_group_row(tag, peaks, gen, group, stopo, sstatic.members[0].mesh_plan.plans,
                                                    masks, rows, Bk, bands, x)

    # the Ricci balancer before RMP on 2 x 2: SDRF with K5 in the trainer's
    # prepare (once: the static does not depend on the compute type), bf16 as
    # shipped, then float32 with the degree control
    group = group_of((2, 2))
    frames, normal, _ = draws(16)
    bstatic = bstate = None
    for dtype_name in ("bfloat16", "float32"):
        bconfig = rmp_config(**({} if dtype_name == "bfloat16" else {"compute_dtype": None}))
        bal = bconfig["params"]["model"]["graph_balancer"]
        bal["algorithm"] = "ricci"
        if (bal["ricci"]["loops"], bal["ricci"]["tau"], bal["remove_edges"], bal["frequency"]) != (150, 150, True, 1):
            raise AssertionError(f"flag_full_scale's graph_balancer changed: {bal}")
        bmodel = get_model(bconfig)
        btrainer = Trainer(bmodel, bconfig)
        btopo = bmodel.topology_from_trajectory(traj, device="cuda")
        if bstatic is None:
            reset_counts()  # the trainer's prepare is on the main path: 2 K5 per SDRF loop
            t0 = time.perf_counter()
            bstatic = btrainer.expansion.prepare(bmodel, frame0, btopo)
            torch.cuda.synchronize()
            prepare_s = time.perf_counter() - t0
            counts = read_counts()
            if counts != {**dict.fromkeys(counts, 0), "K5": 2 * sdrf.loops_run}:
                raise AssertionError(f"balancer prepare: launches {counts}, want {2 * sdrf.loops_run} K5")
            launches["K5"] += counts["K5"]
            loops = sdrf.loops_run
            bhyper = torch.randn(btrainer.expansion.hyper_noise_shape(bmodel, frames, bstatic), generator=gen,
                                 device="cuda")
            bstate = bmodel.init_state(torch.Generator().manual_seed(seed)).to("cuda")
            with torch.no_grad():  # normalizers over the trajectory, the expansion's included
                ev = {k: v.cuda() for k, v in every.items()}
                graph, _, bstate = bmodel.make_graph(bstate, btopo, ev, True)
                _, bstate = btrainer.expansion.expand(bstate, graph, ev, bmodel, True, static=bstatic,
                                                      generator=torch.Generator(device="cuda").manual_seed(seed + 3))
                _, bstate = bmodel.get_target(bstate, ev, True)
        ts = btrainer.init_train_state(state=bstate)
        ref_loss, _ = btrainer.loss_and_grads(ts, btopo, frames, normal=normal, static=bstatic, hyper_normal=bhyper)
        ref_grads = grads_of(ts.model.params)
        bstopo = shard_topology(btopo, group)
        bstep = make_spmd_train_step(btrainer, bstopo, group)
        run = lambda st: bstep.loss_and_grads(ts, frames, normal=normal, static=st, hyper_normal=bhyper)
        t0 = time.perf_counter()
        (loss, _), counts = counted(f"sharded balancer step {dtype_name}", lambda: run(bstatic),
                                    {"K1": blocks * 4, "K2": blocks * 4})
        bal_ms = 1e3 * (time.perf_counter() - t0)
        sound = grads_of(ts.model.params)
        errs = tiered_errors(loss, sound, ref_loss, ref_grads)
        if not tiered_ok(errs, dtype_name):
            raise AssertionError(f"sharded balancer step {dtype_name} vs single-device: {tiered_text(errs)}; "
                                 f"limits {SPMD_RMP_TOL[dtype_name]}")
        sstatic = bstep.laid_out(bstatic)
        keep = sstatic.members[0].mesh_keep.cpu().numpy()
        control_errs = None
        if dtype_name == "float32":  # every mesh plan's degree from the unmasked topology: must miss
            unmasked = torch.from_numpy(np.bincount(bstopo.receivers.cpu().numpy()[bstopo.mask.cpu().numpy() > 0],
                                                    minlength=rows).astype(np.float32))
            control = ShardedStatic(
                topo=sstatic.topo._replace(plan=with_degree(sstatic.topo.plan, unmasked[:N])),
                members=(sstatic.members[0],
                         sstatic.members[1]._replace(mesh_plan=with_degree(sstatic.members[1].mesh_plan, unmasked))))
            closs, _ = run(control)
            control_errs = tiered_errors(closs, grads_of(ts.model.params), ref_loss, ref_grads)
            if tiered_ok(control_errs, dtype_name):
                raise AssertionError(f"sharded balancer step: the unmasked topology's degree passed the float32 "
                                     f"limits: {tiered_text(control_errs)}")
            # the laid-out static again after another one: the same gradients bit for bit (each
            # backward reads every rank's forward tensors on one stream: used_on_this_stream)
            run(bstatic)
            again = grads_of(ts.model.params)
            if not all(torch.equal(sound[n], again[n]) for n in sound):
                raise AssertionError("sharded balancer step: a run after the control's differs from the first")
            # a second draw of both noises, the control first this time: each against the
            # single-device step on that draw (the limits must hold over draws, not one)
            normal2 = torch.randn(normal.shape, generator=gen, device="cuda")
            bhyper2 = torch.randn(bhyper.shape, generator=gen, device="cuda")
            ref2_loss, _ = btrainer.loss_and_grads(ts, btopo, frames, normal=normal2, static=bstatic,
                                                   hyper_normal=bhyper2)
            ref2 = grads_of(ts.model.params)
            run2 = lambda st: bstep.loss_and_grads(ts, frames, normal=normal2, static=st, hyper_normal=bhyper2)
            closs2, _ = run2(control)
            second = dict(degree_control=tiered_errors(closs2, grads_of(ts.model.params), ref2_loss, ref2))
            sloss2, _ = run2(bstatic)
            second["errors"] = tiered_errors(sloss2, grads_of(ts.model.params), ref2_loss, ref2)
            if not tiered_ok(second["errors"], dtype_name):
                raise AssertionError(f"sharded balancer step {dtype_name}, second draw, vs single-device: "
                                     f"{tiered_text(second['errors'])}; limits {SPMD_RMP_TOL[dtype_name]}")
            if tiered_ok(second["degree_control"], dtype_name):
                raise AssertionError(f"sharded balancer step, second draw: the unmasked topology's degree passed "
                                     f"the float32 limits: {tiered_text(second['degree_control'])}")
        group.check()
        timings[f"rmp+balancer 2x2 {dtype_name}"] = dict(
            B=16, prepare_s=prepare_s, sdrf_loops=loops, removed_edges=int((keep == 0).sum()),
            step_ms=bal_ms, errors=errs, degree_control=control_errs, launches=counts)
        log(f"sharded step rmp+balancer 2x2 {dtype_name} (B=16; prepare {prepare_s:.3f} s, {loops} SDRF loops, "
            f"{int((keep == 0).sum())} mesh edges removed): {counts['K1']} K1 + {counts['K2']} K2; vs "
            f"single-device: {tiered_text(errs)}; {bal_ms:.1f} ms checked run [{card}]")
        if control_errs is not None:
            timings[f"rmp+balancer 2x2 {dtype_name}"]["second_draw"] = second
            log(f"  the unmasked topology's degree (control): {tiered_text(control_errs)}, misses the float32 "
                f"limits {SPMD_RMP_TOL['float32']} [{card}]")
            log(f"  second draw: sound {tiered_text(second['errors'])}; control "
                f"{tiered_text(second['degree_control'])}, misses [{card}]")

    # the sorted path, cut in depth: the mesh set's K4f on each data row's
    # joined shards and K4b in one node per data row; the tier sets unfused
    sconfig = rmp_config(agg_vjp="sorted", message_passing_steps=SPMD_SORTED_BLOCKS)
    smodel = get_model(sconfig)
    strainer = Trainer(smodel, sconfig)
    stopo_s = smodel.topology_from_trajectory(traj, device="cuda")
    sstatic_s = strainer.expansion.prepare(smodel, frame0, stopo_s)
    sts = strainer.init_train_state(state=rmp_state(sconfig, traj, seed))
    frames, normal, hyper = draws(8)
    ref_loss, _ = strainer.loss_and_grads(sts, stopo_s, frames, normal=normal, static=sstatic_s, hyper_normal=hyper)
    ref_grads = grads_of(sts.model.params)
    sharded_s = shard_topology(stopo_s, group)
    sstep = make_spmd_train_step(strainer, sharded_s, group)
    rows_per = SPMD_SORTED_BLOCKS * group.shape["data"]
    t0 = time.perf_counter()
    (loss, _), counts = counted("sharded sorted step", lambda: sstep.loss_and_grads(
        sts, frames, normal=normal, static=sstatic_s, hyper_normal=hyper), {"K4f": rows_per, "K4b": rows_per})
    sorted_ms = 1e3 * (time.perf_counter() - t0)
    errs = tiered_errors(loss, grads_of(sts.model.params), ref_loss, ref_grads)
    if not tiered_ok(errs):
        raise AssertionError(f"sharded sorted step vs single-device: {tiered_text(errs)}; limits "
                             f"{SPMD_RMP_TOL['bfloat16']}")
    timings["rmp sorted 2x2"] = dict(B=8, blocks=SPMD_SORTED_BLOCKS, step_ms=sorted_ms, errors=errs, launches=counts)
    log(f"sharded step rmp sorted 2x2 (cut to {SPMD_SORTED_BLOCKS} of 15 blocks for the time limit, B=8): "
        f"{counts['K4f']} K4f + {counts['K4b']} K4b on the joined shards; vs single-device (K4f/K4b): "
        f"{tiered_text(errs)}; {sorted_ms:.1f} ms checked run [{card}]")
    kernel_rows.update(sorted_joined_rows(peaks, gen, sharded_s, 8 // group.shape["data"]))

    # the sharded forward with RMP on 2 x 2 against the single-device forward
    frames = {k: v[:8].cuda() for k, v in every.items()}
    mstate = state.to("cuda")
    fwd = make_sharded_forward(model, shard_topology(topo, group), group, expansion=trainer.expansion)
    out, counts = counted("sharded forward rmp 2x2", lambda: fwd(mstate, frames, static=static), {"K1": blocks * 4})
    with torch.no_grad():
        graph, _, _ = model.make_graph(mstate, topo, frames, False)
        graph, _ = trainer.expansion.expand(mstate, graph, frames, model, is_training=False, static=static)
        single = model.forward(mstate, graph)
    scale = float(single.abs().max())
    err = float((out - single).abs().max())
    if err > SERVE_TOL["net_out"] * scale or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sharded forward rmp 2x2: max err {err} of max {scale}")
    timings["rmp forward 2x2"] = dict(B=8, launches=counts, max_err_vs_single=err, out_scale=scale)
    log(f"sharded forward rmp 2x2 (B=8): {counts['K1']} K1; vs single-device max err {err:.3g} of max "
        f"{scale:.3g} [{card}]")

    for name, r in kernel_rows.items():
        log(f"{name} ({r['shape']}): {r['ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
            f"plain {r['plain_ms']:.3f} ms, max abs err {r['max_abs_err']:.3g} [{card}]")
    faulthandler.cancel_dump_traceback_later()
    log(f"spmd rmp: {time.perf_counter() - t_phase:.1f} s, watchdog disarmed")
    return launches, timings, kernel_rows


SPMD_MODELS = ("cylinder", "plate", "hgn_plate")
SPMD_MODELS_FRAMES = (4, 20)  # the 16 frames trained: plate's stamp touches the plate in every one
SPMD_MODELS_STEPS = (1, 1)  # warm-up and timed steps, sharded and single-device, per family (cut for the time limit)
SPMD_MODELS_DRAWS = 2  # noise draws the limits hold over
# The sharded step against the single-device step on the card, float32, 5
# blocks, B = 16 (1 x 4: 8), same state and noise draws, the state's
# normalizers at their accumulation cap (capped: on the 36x36 plate every
# mesh edge has one length, and a batch accumulated into the mesh_edge
# normalizer standardizes float32 rounding; the normalizers' accumulation is
# held on its own, from the uncapped state): loss relative error, the worst
# gradient relative L2 of the mesh tier and of the cluster tier, the worst
# normalizer field's relative error, the sharded forward's largest error
# over its largest output.  Set from this phase's readings on an NVIDIA H100
# 80GB HBM3 at 700 W over two noise draws (PERF.md section 6, PR 16): sound
# loss 0-1.02e-7, mesh tier 2.7e-7 (plate) to 1.82e-4 (HGN plate), cluster
# tier 9.6e-5-1.94e-4, normalizers 6.5e-8-1.9e-7, the forward 1.1e-6-2.2e-6;
# the planted faults: loss 1.16e-4 (HGN plate's zeroed world partials; a lost
# cylinder shard leaves the loss as it is), mesh tier 1.07 and more, cluster
# tier 5.29e-2.  Each limit sits 10x or more above the largest sound reading
# (HGN plate's gradients jump at near ties in float32: a 1e-7 move of the
# input moves them by up to 2.1e-3 on the CPU) and 10x or more below the
# smallest planted reading; the normalizers and the forward have no control.
SPMD_MODELS_TOL = {"loss": 1e-6, "grad": 2e-3, "tier_grad": 5e-3, "balance_grad": 2e-3, "normalizers": 2e-6,
                   "forward": 2e-5}


@contextlib.contextmanager
def zeroed_world_partials():
    """A planted fault for the sharded plate step: graph rank 0's partials
    of the world set (the set with per-frame receivers; its valid edges come
    first, so graph rank 0 holds them) zeroed before they combine, in the
    forward, as if that rank's world-edge messages were lost."""
    import torch

    from hyper_graph_nets_tpu_torch.core import segment_ops

    kept = segment_ops._sharded_combine

    def zeroed(entries, group, ties):
        if entries[0]["shard"][0].dim() == 2:
            entries = [dict(e, raw=torch.zeros_like(e["raw"])) if group.axis_index(r, "graph") == 0 else e
                       for r, e in enumerate(entries)]
        return kept(entries, group, ties)

    segment_ops._sharded_combine = zeroed
    try:
        yield
    finally:
        segment_ops._sharded_combine = kept


def models_ok(errs):
    tol = SPMD_MODELS_TOL
    return errs["loss"] <= tol["loss"] and all(errs[g][0] <= tol[g] for g in ("grad", "tier_grad", "balance_grad"))


def normalizer_error(got, want):
    """The worst relative error of any normalizer field (count, sums, sums
    of squares) over its largest element, and its name."""
    errs = []
    for name, ns in want.items():
        for f in ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared"):
            w, g = getattr(ns, f).float(), getattr(got[name], f).float()
            errs.append((float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30), f"{name}.{f}"))
    return max(errs)


def phase_spmd_models(card, peaks, seed, profile_dir=None):
    """Train configs/cylinder.yaml, plate.yaml and plateCluster.yaml (HGN
    plate) as shipped (float32, 5 blocks, fused remat, latent 128) through
    ``parallel.sharding.make_spmd_train_step`` on a 2 x 2 group at B = 16, all
    ranks on the one card: K1 raw + K2 per mesh shard (over N + K rows on
    HGN plate, its tier sets unfused), plate's world set built whole by
    every graph rank of a data row and cut into per-rank slices with their
    own fixed-order sums.  Launches counted in advance; loss and gradients
    against the single-device step on the card over SPMD_MODELS_DRAWS noise
    draws, and the normalizer states from an uncapped state
    (SPMD_MODELS_TOL); two runs bit for bit; planted faults that must miss
    the limits (plate and HGN plate: graph rank 0's world-set partials
    zeroed; cylinder: a lost shard's K2 output); step ms beside the
    single-device step; ``make_sharded_forward`` on 2 x 2 at B = 8 against
    the single-device forward; cylinder on a 1 x 4 group with overlap bands
    at B = 8 (K7, then K2).  K1 raw and K2 in float32 at each family's shard
    shapes, and K7 at cylinder's, against their plain versions.  A watchdog
    ends the run if the phase hangs."""
    import faulthandler

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import (
        make_sharded_forward,
        make_spmd_train_step,
        shard_topology,
    )
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    faulthandler.dump_traceback_later(SPMD_WATCHDOG_S, exit=True)
    log(f"spmd models: watchdog armed ({SPMD_WATCHDOG_S} s)")
    t_phase = time.perf_counter()
    group_of = lambda shape: RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
    grads_of = lambda params: {n: p.grad.detach().clone() for n, p in params.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    launches, timings, kernel_rows = dict.fromkeys(read_counts(), 0), {}, {}
    lo, hi = SPMD_MODELS_FRAMES
    B = hi - lo

    def counted(tag, fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        full = dict.fromkeys(counts, 0)
        full.update(want)
        if counts != full:
            raise AssertionError(f"{tag}: launches {counts}, want {full}")
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    for name in SPMD_MODELS:
        family = "cylinder" if name == "cylinder" else "plate"
        config = hgn_config() if name == "hgn_plate" else model_config(name)
        model = get_model(config)
        blocks = model.gnn_config.message_passing_steps
        traj = model_trajectory(family, seed, hi + 3)
        state = rmp_state(config, traj, seed) if name == "hgn_plate" else model_state(model, traj, seed)
        trainer = Trainer(model, config)
        topo = model.topology_from_trajectory(traj, device="cuda")
        static = None
        if trainer.expansion is not None:
            static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        N, E = topo.num_nodes, int(topo.senders.shape[0])
        rows = N + (static[0].num_clusters if static is not None else 0)
        if (N, E) != MODEL_SIZES[family]:
            raise AssertionError(f"spmd {name}: {N} nodes, {E} mesh edges, want {MODEL_SIZES[family]}")
        frames = {k: torch.as_tensor(v[lo:hi]).cuda() for k, v in traj.items() if k != "cells"}
        field = MODEL_FIELDS[family]

        def draw(b):
            normal = torch.randn(frames[field][:b].shape, generator=gen, device="cuda")
            hyper = None
            if static is not None:
                sub = {k: v[:b] for k, v in frames.items()}
                hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, sub, static), generator=gen,
                                    device="cuda")
            return normal, hyper

        group = group_of((2, 2))
        stopo = shard_topology(topo, group)
        step = make_spmd_train_step(trainer, stopo, group)
        cstate = capped(state)
        ts = trainer.init_train_state(state=cstate)

        def single(tstate, fr, normal, hyper):
            loss, norms = trainer.loss_and_grads(tstate, topo, fr, normal=normal, static=static, hyper_normal=hyper)
            return loss, grads_of(tstate.model.params), norms

        def sharded(tstate, fr, normal, hyper, s=step):
            loss, norms = s.loss_and_grads(tstate, fr, normal=normal, static=static, hyper_normal=hyper)
            return loss, grads_of(tstate.model.params), norms

        want = {"K1": blocks * group.n, "K2": blocks * group.n}
        sound, first = [], None
        for d in range(SPMD_MODELS_DRAWS):
            normal, hyper = draw(B)
            ref_loss, ref_grads, _ = single(ts, frames, normal, hyper)
            # the main path: every count set to 0 just before, read just after
            (loss, grads, _), counts = counted(f"sharded {name} 2x2 draw {d}",
                                               lambda: sharded(ts, frames, normal, hyper), want)
            group.check()
            errs = tiered_errors(loss, grads, ref_loss, ref_grads)
            sound.append(errs)
            if first is None:
                first = (loss, grads, normal, hyper, ref_loss, ref_grads, counts)
            log(f"sharded {name} 2x2 draw {d}: {tiered_text(errs)} [{card}]")
            if not models_ok(errs) or not np.isfinite(float(loss)):
                raise AssertionError(f"sharded {name} 2x2 draw {d} vs single-device: {tiered_text(errs)}; limits "
                                     f"{SPMD_MODELS_TOL}")
        loss, grads, normal, hyper, ref_loss, ref_grads, counts = first
        loss2, grads2, _ = sharded(ts, frames, normal, hyper)
        if not (torch.equal(loss, loss2) and all(torch.equal(grads[n], grads2[n]) for n in grads)):
            raise AssertionError(f"sharded {name} 2x2: a second run differs from the first")
        # the planted fault: must miss the limits
        fault = "lost shard's K2 output" if name == "cylinder" else "graph rank 0's world-set partials zeroed"
        with (lost_shard_grads(group.shape["graph"]) if name == "cylinder" else zeroed_world_partials()):
            floss, fgrads, _ = sharded(ts, frames, normal, hyper)
        planted = tiered_errors(floss, fgrads, ref_loss, ref_grads)
        if models_ok(planted):
            raise AssertionError(f"sharded {name} 2x2: the planted fault ({fault}) passed the limits: "
                                 f"{tiered_text(planted)}")
        log(f"sharded {name} 2x2 planted fault ({fault}): {tiered_text(planted)}, misses [{card}]")
        # the normalizers' accumulation over the data ranks, from the uncapped state
        tsu = trainer.init_train_state(state=state)
        _, _, norms_ref = single(tsu, frames, normal, hyper)
        nloss, _, norms = sharded(tsu, frames, normal, hyper)
        norm_err = normalizer_error(norms, norms_ref)
        if not norm_err[0] <= SPMD_MODELS_TOL["normalizers"]:
            raise AssertionError(f"sharded {name} 2x2 normalizer states vs single-device: {norm_err}")
        group.check()

        # step time: the full step (Adam included) beside the single-device step, each after a warm-up step
        warm, timed_steps = SPMD_MODELS_STEPS

        def step_ms(fn, tstate):
            for _ in range(warm):
                tstate, _ = fn(tstate)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                tstate, out = fn(tstate)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / timed_steps, out

        ms, last = step_ms(lambda t: step(t, frames, normal=normal, static=static, hyper_normal=hyper),
                           trainer.init_train_state(state=cstate))
        group.check()
        single_ms, _ = step_ms(lambda t: trainer.train_step(t, topo, frames, normal=normal, static=static,
                                                            hyper_normal=hyper), trainer.init_train_state(state=cstate))
        if not np.isfinite(float(last)):
            raise AssertionError(f"sharded {name} 2x2: loss {float(last)} after the timed steps")
        if profile_dir:
            device_profile(lambda: sharded(ts, frames, normal, hyper), card, profile_dir, f"spmd_{name}_2x2")
        world = None
        if family == "plate":
            with torch.no_grad():
                wm = model.frame_features(topo, frames)["world_mask"]
            world = dict(slots=int(wm.shape[-1]), hits_min=int(wm.sum(-1).min()), hits_max=int(wm.sum(-1).max()))
        E_pad = int(stopo.senders.shape[0])
        timings[f"{name} 2x2"] = dict(
            B=B, ranks=group.n, nodes=N, rows=rows, edges=E, edges_padded=E_pad, step_ms=ms,
            edges_per_s=B * E / (ms / 1e3), single_device_step_ms=single_ms, draws=sound, planted=planted,
            planted_fault=fault, normalizers=norm_err, launches=counts, world_edges=world)
        log(f"sharded step {name} 2x2 (configs/{HGN_CONFIG if name == 'hgn_plate' else name}.yaml float32 as "
            f"shipped, B={B}, 4 ranks on one card, "
            f"{E_pad // 2} mesh edges per graph rank over {rows} rows"
            + (f", world set {world['slots']} slots a frame ({world['hits_min']}-{world['hits_max']} valid), "
               f"{world['slots'] // 2} per graph rank" if world else "")
            + f"): {counts['K1']} K1 raw + {counts['K2']} K2; vs single-device over {SPMD_MODELS_DRAWS} draws: "
            + "; ".join(tiered_text(e) for e in sound)
            + f"; normalizers {norm_err[0]:.3g} ({norm_err[1]}); a second run bit for bit; {ms:.1f} ms per step "
            f"(host clock, Adam included, {timed_steps} after {warm} warm-up; single-device step "
            f"{single_ms:.1f} ms), {B * E / (ms / 1e3):.4g} mesh edges/s [{card}]")

        # the sharded forward on 2 x 2 at B = 8 against the single-device forward
        half = {k: v[:8] for k, v in frames.items()}
        mstate = state.to("cuda")
        fwd = make_sharded_forward(model, stopo, group, expansion=trainer.expansion)
        out, fcounts = counted(f"sharded forward {name} 2x2", lambda: fwd(mstate, half, static=static),
                               {"K1": blocks * group.n})
        with torch.no_grad():
            graph, _, _ = model.make_graph(mstate, topo, half, False)
            if trainer.expansion is not None:
                graph, _ = trainer.expansion.expand(mstate, graph, half, model, is_training=False, static=static)
            ref = model.forward(mstate, graph)
        scale = float(ref.abs().max())
        ferr = float((out - ref).abs().max()) / scale
        if not ferr <= SPMD_MODELS_TOL["forward"] or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"sharded forward {name} 2x2: max err {ferr} of the largest output {scale}")
        timings[f"{name} forward 2x2"] = dict(B=8, launches=fcounts, max_err_vs_single=ferr, out_scale=scale)
        log(f"sharded forward {name} 2x2 (B=8): {fcounts['K1']} K1 raw; vs single-device max err {ferr:.3g} of the "
            f"largest output {scale:.3g} [{card}]")

        # K1 raw and K2 in float32 at this family's shard shape
        per, plan = stopo.layout.per, stopo.plan.plans[0]
        if static is not None:
            plan = step.laid_out(static).members[0].mesh_plan.plans[0]
        host = lambda t, k: t[k * per : (k + 1) * per].cpu().numpy()
        found, x = shard_kernel_rows(f"{name} 2x2", peaks, gen, host(stopo.senders, 0), host(stopo.receivers, 0),
                                     host(stopo.mask, 0), plan, rows, B // 2, seed + 32, "float32")
        kernel_rows[f"K1 raw {name} 2x2"], kernel_rows[f"K2 {name} 2x2"] = found["K1 raw"], found["K2"]

        if name == "cylinder":  # the 1 x 4 overlap group at B = 8: K7, then K2
            group4 = group_of((1, 4))
            stopo4 = shard_topology(topo, group4, overlap_bands=HALO_BANDS)
            step4 = make_spmd_train_step(trainer, stopo4, group4)
            normal8, _ = draw(8)
            ref_loss, ref_grads, _ = single(ts, half, normal8, None)
            (loss, grads, _), counts4 = counted("sharded cylinder 1x4 overlap", lambda: sharded(
                ts, half, normal8, None, step4), {"K7": blocks * group4.n, "K2": blocks * group4.n})
            group4.check()
            errs4 = tiered_errors(loss, grads, ref_loss, ref_grads)
            if not models_ok(errs4):
                raise AssertionError(f"sharded cylinder 1x4 overlap vs single-device: {tiered_text(errs4)}")
            timings["cylinder 1x4 overlap"] = dict(B=8, errors=errs4, launches=counts4,
                                                   edges_padded=int(stopo4.senders.shape[0]))
            log(f"sharded step cylinder 1x4 overlap {HALO_BANDS} (B=8): {counts4['K7']} K7 + {counts4['K2']} K2; "
                f"vs single-device: {tiered_text(errs4)} [{card}]")
            per4 = stopo4.layout.per
            masks = [stopo4.mask[k * per4 : (k + 1) * per4].cpu().numpy() for k in range(group4.n)]
            found4, x4 = shard_kernel_rows("cylinder 1x4 overlap", peaks, gen,
                                           stopo4.senders[:per4].cpu().numpy(), stopo4.receivers[:per4].cpu().numpy(),
                                           masks[0], stopo4.plan.plans[0], N, 8, seed + 33, "float32")
            kernel_rows["K2 cylinder 1x4 overlap"] = found4["K2"]
            kernel_rows["K7 cylinder 1x4 overlap"] = k7_group_row("cylinder 1x4 overlap", peaks, gen, group4, stopo4,
                                                                  stopo4.plan.plans, masks, N, 8, HALO_BANDS, x4,
                                                                  "float32")

    for tag, r in kernel_rows.items():
        log(f"{tag} ({r['shape']}): {r['ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
            f"plain {r['plain_ms']:.3f} ms, max abs err {r['max_abs_err']:.3g} [{card}]")
    faulthandler.cancel_dump_traceback_later()
    log(f"spmd models: {time.perf_counter() - t_phase:.1f} s, watchdog disarmed")
    return launches, timings, kernel_rows


# The hybrid fused block (model.fused_fwd: xla, phase_hybrid): the unfused
# forward in PyTorch (the JAX package computes it outside any Pallas kernel;
# no kernel on the card), then K2 with a tie tolerance
# (ops.fused_block.HYBRID_TIE_TOL: 2**-8 in bf16, 1e-5 in float32).  Its
# train step against the fused K1/K2 step's on the same state and noise: the
# loss within HYBRID_FUSED_LOSS_TOL * max(1, |loss|): float32 1e-4, as the JAX
# package's test_hybrid_fwd_matches_xla holds its float32 hybrid
# (tests/test_fused_block.py:455-464); bf16 2**-5, TRAIN_TOL's bf16 loss limit
# (the two forwards round e2 at other points, as card and CPU do).  Against
# the CPU's at B = CPU_FRAMES within TRAIN_TOL: flag in bf16 as shipped,
# cylinder in float32 (flag's float32 run cut for the script's time limit).
# K2 with the tolerance against its plain version on K1's forward
# values (BWD_TOL), its drhs the hybrid forward's aggregate, as the main path
# builds it; its routed max/min mass equal to the count of tolerant winners
# of K1's e2 (exact: counts).
HYBRID_FUSED_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
HYBRID_STEPS = 3  # timed steps of the hybrid and the fused step each, in turns, after a warm-up of each


def winner_counts(e2, drhs, receivers, num_nodes, tie_tol):
    """For K2's tie compare of ``e2`` (K1's, which K2 recomputes bit for
    bit) against the extrema in ``drhs`` (rounded to e2's type, as K2 reads
    them): the count of (edge, column) winners of the max and min over
    every frame, ``[L]`` per column, and the number of (frame, receiver,
    column) extrema that no edge wins (``[sum, ...]`` over max and min)."""
    import torch

    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    L = e2.shape[-1]
    r = receivers.long()
    got = drhs.to(e2.dtype).float()[:, r]
    v = e2.float()
    wins, lost = 0, 0
    has = torch.zeros(num_nodes, device=e2.device).index_add_(0, r, torch.ones_like(r, dtype=torch.float32)) > 0
    for k in (1, 3):  # max, min
        win = fb.ties(v, got[..., k * L : (k + 1) * L], tie_tol).float()
        wins = wins + win.sum(dim=(0, 1))
        per = torch.zeros(e2.shape[0], num_nodes, L, device=e2.device).index_add_(1, r, win)
        lost += int(((per == 0) & has[None, :, None]).sum())
    return wins, lost


def phase_hybrid(card, peaks, seed):
    """The hybrid (``model.fused_fwd: xla``) on configs/flag_full_scale.yaml
    with RMP off (bf16, 15 blocks, B = 21) and on configs/cylinder.yaml
    (float32, 5 blocks, B = 16): K2 with the tie tolerance against its plain
    version at both shapes, on drhs from the hybrid forward's aggregate,
    with the near ties that forward leaves (K1's e2 within the tolerance of
    the extremum but not equal) counted, and its routed max/min mass equal
    to the tolerant winners of K1's e2; the planted control: the exact
    compare (tie_tol 0) on the same inputs leaves extrema that no edge wins,
    which the tolerance routes, and the bf16 train step with tie_tol 0
    differs from the tolerant one.  The main paths: a train step of each
    (15, then 5, K2 with the tolerance; no K1, K3 or K7) and a one_step at
    B = 21 (no kernel: the forward is PyTorch's, as the JAX package's
    forward runs no Pallas kernel), launches counted; the train step
    against the CPU's and its loss against the fused K1/K2 step's; step
    times of both in turns (no claim)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    launches, timings, rows = dict.fromkeys(read_counts(), 0), {}, {}
    L = L_MAIN
    gen = torch.Generator().manual_seed(seed + 41)
    grads_of = lambda params: {n: p.grad.detach().clone() for n, p in params.named_parameters()}
    flag_traj = add_targets(flag_trajectory(num_steps=TRAIN_FRAMES + 2, nx=40, ny=40, seed=seed), "world_pos",
                            history=True)

    def cylinder_config(**model):
        config = model_config("cylinder")
        config["params"]["model"].update(model)
        return config

    cases = {
        "flag": dict(config=main_config, traj=flag_traj, B=TRAIN_FRAMES, dtype="bfloat16", blocks=15),
        "cylinder": dict(config=cylinder_config, traj=model_trajectory("cylinder", seed, MODEL_FRAMES + 3),
                         B=MODEL_FRAMES, dtype="float32", blocks=5),
    }
    for name, c in cases.items():
        config = c["config"](fused_fwd="xla")
        model = get_model(config)
        cfg = model.gnn_config
        if (cfg.fused_fwd, cfg.agg_vjp, cfg.message_passing_steps, cfg.compute_dtype) != (
                "xla", "fused", c["blocks"], None if c["dtype"] == "float32" else c["dtype"]):
            raise AssertionError(f"hybrid {name} config: {cfg}")
        trainer = Trainer(model, config)
        topo = model.topology_from_trajectory(c["traj"], device="cuda")
        if name == "flag":
            state = model.init_state(torch.Generator().manual_seed(seed))
            ctopo = model.topology_from_trajectory(c["traj"], device="cpu")
            every = {k: torch.as_tensor(v) for k, v in c["traj"].items() if k != "cells"}
            with torch.no_grad():
                _, _, state = model.make_graph(state, ctopo, every, True)
                _, state = model.get_target(state, every, True)
        else:
            state = model_state(model, c["traj"], seed)
        B, dtype_name = c["B"], c["dtype"]
        dtype = getattr(torch, dtype_name)
        tol = fb.HYBRID_TIE_TOL[dtype]
        N, E = topo.num_nodes, int(topo.senders.shape[0])
        snd, rcv = topo.senders.cpu().numpy(), topo.receivers.cpu().numpy()
        tag = f"{dtype_name} B={B} N={N} E={E} ({name})"

        # 1. K2 with the tolerance against its plain version, drhs from the hybrid forward
        x = k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda")
        targs = (x["senders"], x["receivers"], x["mask"], N)
        plan = topo.plan
        gidx, gval = (torch.as_tensor(a).cuda() for a in receivers_to_gather(rcv, N))
        _, agg = fb.hybrid_forward(x["e"], x["sp"], x["rp"], x["weights"], x["senders"], x["receivers"], gidx, gval)
        e2, _, a1, a2, _, _ = fb.fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *targs, plan,
                                                      save_streams=True)
        dagg = torch.randn(agg.shape, generator=gen).cuda()
        de2 = torch.randn(x["e"].shape, generator=gen).to(dtype).cuda()
        drhs = fb.agg_cotangent_rhs(agg, dagg, x["receivers"], x["mask"], N)
        run = lambda d=de2, r=drhs, t=tol: fb.fused_edge_block_bwd(x["e"], x["sp"], x["rp"], x["weights"], d, r,
                                                                  *targs, plan=plan, tie_tol=t)
        got = run()
        want = fb.fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *targs,
                                                 forward=(e2, a1, a2), tie_tol=tol)
        order = lambda o: (o[0], o[1], o[2], o[3], o[6], o[7], o[8])
        err = compare_bwd(f"K2 tie {tag}", dtype_name, order(got), order(want))
        # the routed mass (de2 0, only g_max = g_min = 1) against the tolerant winners of K1's e2
        zero = torch.zeros_like(de2)
        rdagg = torch.zeros_like(dagg)
        rdagg[..., 2 * L :] = 1.0
        rdrhs = fb.agg_cotangent_rhs(agg, rdagg, x["receivers"], x["mask"], N)
        wins, lost = winner_counts(e2, rdrhs, x["receivers"], N, tol)
        exact_wins, exact_lost = winner_counts(e2, rdrhs, x["receivers"], N, 0.0)
        mass = run(zero, rdrhs)[-1][4]
        if not torch.equal(mass, wins):
            raise AssertionError(f"K2 tie {tag}: routed mass differs from the tolerant winner count in "
                                 f"{int((mass != wins).sum())} columns")
        exact_mass = run(zero, rdrhs, 0.0)[-1][4]
        if not torch.equal(exact_mass, exact_wins):
            raise AssertionError(f"K2 {tag} (tie_tol 0): routed mass differs from the exact winner count")
        near = int((wins - exact_wins).sum())
        if exact_lost == 0:
            log(f"K2 tie {tag}: the hybrid forward's extrema all equal K1's e2 exactly: no near tie to route")
        elif not lost < exact_lost:
            raise AssertionError(f"K2 tie {tag}: the tolerance left {lost} extrema unwon, the exact compare "
                                 f"{exact_lost}")
        k2b = bwd_bound_ms(dtype_name, B, E, N, L, peaks, False)
        rows[name] = dict(
            max_abs_err=err, ms=kernel_device_ms(run, iters=10, names=BWD_KERNELS),
            plain_ms=cuda_time_ms(lambda: fb.fused_edge_block_bwd_reference(
                x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *targs, tie_tol=tol), iters=3),
            bound_ms=k2b[0], bound_by=k2b[1], tie_tol=tol, near_ties=near, unwon_extrema=lost,
            unwon_extrema_exact=exact_lost, shape=f"{tag}, tie_tol {tol:g}")
        r = rows[name]
        log(f"K2 tie {tag}, tie_tol {tol:g}: {r['ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, max abs err {err:.3g}; {near} (edge, column) "
            f"near ties routed beyond the exact compare; extrema no edge wins: {lost} with the tolerance, "
            f"{exact_lost} with tie_tol 0 (the planted control) [{card}]")

        # 2. the main path: a train step (and, on flag, a one_step), every count set to 0 just before
        frames = trainer.frames({k: v[:B] for k, v in c["traj"].items()})
        field = model.field
        normal = torch.randn(frames[field].shape, generator=torch.Generator().manual_seed(seed + 42)).cuda()
        reset_counts()
        ts, loss = trainer.train_step(trainer.init_train_state(state=state), topo, frames, normal=normal)
        torch.cuda.synchronize()
        counts = read_counts()
        wantc = {**dict.fromkeys(counts, 0), "K2": c["blocks"], "K2 tie": c["blocks"]}
        if counts != wantc or not np.isfinite(float(loss)):
            raise AssertionError(f"hybrid {name} train step: launches {counts}, want {wantc}; loss {float(loss)}")
        for k in launches:
            launches[k] += counts[k]
        timings[name] = dict(B=B, train_launches=counts)
        if name == "flag":
            predictor = Predictor.from_config(config)
            predictor.state = state.to(predictor.device)
            reset_counts()
            pred = predictor.one_step({k: v[:ONE_STEP_FRAMES] for k, v in c["traj"].items()})
            torch.cuda.synchronize()
            one = read_counts()
            if any(one.values()) or pred.shape != (ONE_STEP_FRAMES, N, 3) or not np.isfinite(pred).all():
                raise AssertionError(f"hybrid one_step: launches {one} (want none), output {pred.shape}")
            timings[name]["one_step_launches"] = one
            log(f"hybrid one_step (flag MGN-15MP bf16, B={ONE_STEP_FRAMES}): no kernel launched, as the JAX "
                f"package's hybrid forward runs no Pallas kernel: the forward is PyTorch's [{card}]")

        # 3. the loss against the fused K1/K2 step's, same state and noise; the tie_tol 0 step (control)
        fconfig = c["config"]()
        fmodel = get_model(fconfig)
        ftrainer = Trainer(fmodel, fconfig)
        hts, fts = trainer.init_train_state(state=state), ftrainer.init_train_state(state=state)
        hloss, _ = trainer.loss_and_grads(hts, topo, frames, normal=normal)
        hgrads = grads_of(hts.model.params)
        floss, _ = ftrainer.loss_and_grads(fts, topo, frames, normal=normal)
        gap = abs(float(hloss) - float(floss))
        if not gap < HYBRID_FUSED_LOSS_TOL[dtype_name] * max(1.0, abs(float(floss))):
            raise AssertionError(f"hybrid {name}: loss {float(hloss)} vs the fused step's {float(floss)}")
        worst_fused = max((rel_l2(hgrads[n], p.grad), n) for n, p in fts.model.params.named_parameters())
        saved = fb.HYBRID_TIE_TOL[dtype]
        fb.HYBRID_TIE_TOL[dtype] = 0.0
        try:
            zloss, _ = trainer.loss_and_grads(hts, topo, frames, normal=normal)
        finally:
            fb.HYBRID_TIE_TOL[dtype] = saved
        control = max((rel_l2(p.grad, hgrads[n]), n) for n, p in hts.model.params.named_parameters())
        timings[name].update(loss=float(hloss), fused_loss=float(floss), loss_gap=gap,
                             worst_grad_vs_fused=worst_fused, tie_tol_0_grad_change=control)
        log(f"hybrid {name} train step ({dtype_name}, B={B}): {counts['K2 tie']} K2 with tie_tol {tol:g}, no K1; "
            f"loss {float(hloss):.6f} vs the fused K1/K2 step's {float(floss):.6f} (gap {gap:.3g}, limit "
            f"{HYBRID_FUSED_LOSS_TOL[dtype_name]} x max(1, |loss|)); worst gradient vs fused rel L2 {worst_fused[0]:.3g} "
            f"({worst_fused[1]}); with tie_tol 0 (control) the gradients move by up to {control[0]:.3g} "
            f"({control[1]}) [{card}]")

        # 4. the card against the CPU at B = CPU_FRAMES, same state and noise
        with fixed_scatter_order():
            for cmp_dtype in ((("bfloat16",) if name == "flag" else ("float32",))):
                cconfig = c["config"](fused_fwd="xla", compute_dtype=None if cmp_dtype == "float32" else cmp_dtype)
                cmodel = get_model(cconfig)
                small = {k: v[:CPU_FRAMES] for k, v in c["traj"].items()}
                cnormal = torch.randn(small[field].shape, generator=torch.Generator().manual_seed(seed + 43))
                out = {}
                for where in ("cuda", "cpu"):
                    tr = Trainer(cmodel, cconfig, device=where)
                    tss = tr.init_train_state(state=state)
                    closs, _ = tr.loss_and_grads(tss, cmodel.topology_from_trajectory(small, device=where),
                                                 tr.frames(small), normal=cnormal.to(where))
                    out[where] = (float(closs), {n: p.grad.cpu() for n, p in tss.model.params.named_parameters()})
                loss_tol, grad_tol = TRAIN_TOL[cmp_dtype]
                lerr = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
                worst = max((rel_l2(out["cuda"][1][n], g), n) for n, g in out["cpu"][1].items())
                if lerr > loss_tol or worst[0] > grad_tol:
                    raise AssertionError(f"hybrid {name} {cmp_dtype} card vs CPU outside {TRAIN_TOL[cmp_dtype]}: "
                                         f"loss {lerr:.3g}, worst gradient {worst}")
                timings[name][f"vs_cpu_{cmp_dtype}"] = dict(loss_rel=lerr, worst_grad_rel_l2=worst[0])
                log(f"hybrid {name} train step {cmp_dtype} card vs CPU, B={CPU_FRAMES}: loss rel {lerr:.3g}, worst "
                    f"gradient rel L2 {worst[0]:.3g} ({worst[1]}) [{card}]")

        # 5. step times of the hybrid and the fused step, in turns (context: no claim)
        steps = {"hybrid": (trainer, trainer.init_train_state(state=state)),
                 "fused": (ftrainer, ftrainer.init_train_state(state=state))}
        times = {k: [] for k in steps}
        for k in ("hybrid", "fused"):
            tr, tst = steps[k]
            steps[k] = (tr, tr.train_step(tst, topo, frames, normal=normal)[0])
        for i in range(2 * HYBRID_STEPS):
            k = ("hybrid", "fused", "fused", "hybrid")[i % 4]
            tr, tst = steps[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tst, l = tr.train_step(tst, topo, frames, normal=normal)
            float(l)
            times[k].append(1e3 * (time.perf_counter() - t0))
            steps[k] = (tr, tst)
        ms = {k: float(np.median(v)) for k, v in times.items()}
        timings[name].update(step_ms=ms["hybrid"], fused_step_ms=ms["fused"])
        log(f"hybrid {name} train step {ms['hybrid']:.2f} ms, fused K1/K2 step {ms['fused']:.2f} ms (median of "
            f"{HYBRID_STEPS} each, in turns, host clock, Adam included; no claim) [{card}]")
    return launches, timings, rows


# The sharded step on the other RMP architectures (phase_spmd_arch):
# configs/flag_full_scale.yaml as shipped with rmp.connector set to
# multiscale, hetero or multi (spectral, 16 clusters), and with
# rmp.clustering none and rmp.connector repeated, cut to SPMD_ARCH_BLOCKS of
# its 15 blocks at full width (for the script's time limit, as
# phase_spmd_rmp's sorted case), bf16, 2 x 2 at B = 16, held to SPMD_RMP_TOL;
# configs/cylinder.yaml and plate.yaml as shipped with
# graph_balancer.algorithm ricci (the files' loops 150, tau 150, removal,
# frequency 1), float32, 2 x 2 at B = 16, held to SPMD_MODELS_TOL on a
# capped state as phase_spmd_models holds them; cylinder again on a 1 x 4
# group with overlap bands at B = 8.
SPMD_ARCH_BLOCKS = 5
SPMD_ARCHS = {"repeated": ("none", "repeated", 2), "multiscale": ("spectral", "multiscale", 2),
              "hetero": ("spectral", "hetero", 1), "multi": ("spectral", "multi", 0)}  # + fused mesh calls a block


@contextlib.contextmanager
def zeroed_partials(graph_rank=1):
    """A planted fault for the sharded step: one graph rank's aggregate
    partials zeroed before they combine, on every set (fused sets' K1 raw
    partials and unfused sets' local partials alike; on ``multi`` the merged
    set is the only set, unfused), as if its messages were lost."""
    import torch

    from hyper_graph_nets_tpu_torch.core import segment_ops

    kept = segment_ops.combine_partials

    def zeroed(group, raws, F):
        return kept(group, [torch.zeros_like(x) if group.axis_index(r, "graph") == graph_rank else x
                            for r, x in enumerate(raws)], F)

    segment_ops.combine_partials = zeroed
    try:
        yield
    finally:
        segment_ops.combine_partials = kept


def unsharded_keep(sstatic):
    """A planted fault for the sharded balancer step: the balancer's keep
    mask in the unsharded edge order (padded at the end), the JAX package's
    sharded balancer (ROADMAP section 3): on the round-robin layout it masks
    other edges than the ones the balancer removed."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel.sharding import ShardedStatic

    bal = sstatic.members[0]
    keep = torch.empty_like(bal.mesh_keep)
    keep[torch.from_numpy(sstatic.topo.layout.perm).to(keep.device)] = bal.mesh_keep
    return ShardedStatic(topo=sstatic.topo, members=(bal._replace(mesh_keep=keep),) + sstatic.members[1:])


def phase_spmd_arch(card, peaks, seed):
    """The sharded step and forward (``parallel.sharding``) on the RMP
    architectures other than ``hyper`` and with the Ricci balancer on
    cylinder and plate, all ranks on the one card: for each, launches
    counted in advance (K1 raw + K2 per fused mesh call and rank; ``multi``'s
    merged set is unfused: none; the balancer's prepare 2 K5 per SDRF loop),
    loss and gradients against the single-device step on the card, a second
    run bit for bit, a planted fault that must miss the limits (one graph
    rank's partials zeroed; on cylinder's 1 x 4 overlap group the keep mask
    in the unsharded order), and ``make_sharded_forward`` at B = 8 against
    the single-device forward.  A watchdog ends the run if the phase hangs."""
    import faulthandler

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_sharded_forward, make_spmd_train_step, shard_topology
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    faulthandler.dump_traceback_later(SPMD_WATCHDOG_S, exit=True)
    log(f"spmd arch: watchdog armed ({SPMD_WATCHDOG_S} s)")
    t_phase = time.perf_counter()
    group_of = lambda shape: RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
    grads_of = lambda params: {n: p.grad.detach().clone() for n, p in params.named_parameters() if p.grad is not None}
    gen = torch.Generator(device="cuda").manual_seed(seed + 51)
    launches, timings = dict.fromkeys(read_counts(), 0), {}

    def counted(tag, fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        full = {**dict.fromkeys(counts, 0), **want}
        if counts != full:
            raise AssertionError(f"{tag}: launches {counts}, want {full}")
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    def errors(loss, grads, ref_loss, ref_grads):
        return tiered_errors(loss, {n: grads.get(n, torch.zeros_like(g)) for n, g in ref_grads.items()},
                             ref_loss, ref_grads)

    def check_case(tag, trainer, model, topo, static, state, frames, normal, hyper, shape, bands, ok, text, fault,
                   fault_static=None, want_step=None, want_fwd=None):
        """One case: the main path counted, against the single-device step, a
        second run bit for bit, the planted fault, the sharded forward."""
        group = group_of(shape)
        stopo = shard_topology(topo, group, overlap_bands=bands)
        step = make_spmd_train_step(trainer, stopo, group)
        ts = trainer.init_train_state(state=state)
        ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        ref_grads = grads_of(ts.model.params)
        run = lambda st=static: step.loss_and_grads(ts, frames, normal=normal, static=st, hyper_normal=hyper)
        t0 = time.perf_counter()
        (loss, _), counts = counted(f"sharded {tag}", run, want_step)
        ms = 1e3 * (time.perf_counter() - t0)
        group.check()
        grads = grads_of(ts.model.params)
        errs = errors(loss, grads, ref_loss, ref_grads)
        if not ok(errs) or not np.isfinite(float(loss)):
            raise AssertionError(f"sharded {tag} vs single-device: {tiered_text(errs)}")
        loss2, _ = run()
        grads2 = grads_of(ts.model.params)
        if not (torch.equal(loss, loss2) and grads.keys() == grads2.keys()
                and all(torch.equal(grads[n], grads2[n]) for n in grads)):
            raise AssertionError(f"sharded {tag}: a second run differs from the first")
        if fault_static is not None:
            floss, _ = run(fault_static(step.laid_out(static)))
        else:
            with zeroed_partials():
                floss, _ = run()
        planted = errors(floss, grads_of(ts.model.params), ref_loss, ref_grads)
        if ok(planted):
            raise AssertionError(f"sharded {tag}: the planted fault ({fault}) passed the limits: {tiered_text(planted)}")
        group.check()
        out = dict(B=frames[model.field].shape[0], ranks=group.n, step_ms=ms, errors=errs, planted=planted,
                   planted_fault=fault, launches=counts, edges_padded=int(stopo.senders.shape[0]))
        log(f"sharded {tag} (B={out['B']}, {group.n} ranks on one card): {text(counts)}; vs single-device: "
            f"{tiered_text(errs)}; a second run bit for bit; planted fault ({fault}): {tiered_text(planted)}, "
            f"misses; {ms:.1f} ms checked run (host clock) [{card}]")
        if want_fwd is not None:  # the sharded forward at B = 8 against the single-device forward
            half = {k: v[:8] for k, v in frames.items()}
            mstate = state.to("cuda")
            fwd = make_sharded_forward(model, stopo, group, expansion=trainer.expansion)
            fout, fcounts = counted(f"sharded forward {tag}", lambda: fwd(mstate, half, static=static), want_fwd)
            with torch.no_grad():
                graph, _, _ = model.make_graph(mstate, topo, half, False)
                if trainer.expansion is not None:
                    graph, _ = trainer.expansion.expand(mstate, graph, half, model, is_training=False, static=static)
                ref = model.forward(mstate, graph)
            scale = float(ref.abs().max())
            ferr = float((fout - ref).abs().max()) / scale
            limit = SPMD_MODELS_TOL["forward"] if model.gnn_config.compute_dtype is None else SERVE_TOL["net_out"]
            if not ferr <= limit or not bool(torch.isfinite(fout).all()):
                raise AssertionError(f"sharded forward {tag}: max err {ferr} of the largest output {scale}")
            out["forward"] = dict(B=8, launches=fcounts, max_err_vs_single=ferr, out_scale=scale)
            log(f"sharded forward {tag} (B=8): {text(fcounts)}; vs single-device max err {ferr:.3g} of the largest "
                f"output {scale:.3g} [{card}]")
        return out

    # the four architectures on flag HGN at full width, cut to SPMD_ARCH_BLOCKS blocks
    B = 16
    traj = add_targets(flag_trajectory(num_steps=B + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    for arch, (clustering, connector, mesh_calls) in SPMD_ARCHS.items():
        config = rmp_config(message_passing_steps=SPMD_ARCH_BLOCKS)
        config["params"]["model"]["rmp"].update(clustering=clustering, connector=connector)
        model = get_model(config)
        cfg = model.gnn_config
        if (cfg.architecture, cfg.latent_size, cfg.compute_dtype, cfg.agg_vjp) != (arch, 128, "bfloat16", "fused"):
            raise AssertionError(f"spmd arch {arch}: {cfg}")
        trainer = Trainer(model, config)
        topo = model.topology_from_trajectory(traj, device="cuda")
        static = None
        if trainer.expansion is not None:
            static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
            state = rmp_state(config, traj, seed)
        else:
            state = model_state(model, traj, seed)
        frames = {k: torch.as_tensor(v[:B]).cuda() for k, v in traj.items() if k != "cells"}
        normal = torch.randn(frames["world_pos"].shape, generator=gen, device="cuda")
        hyper = None if static is None else torch.randn(
            trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen, device="cuda")
        n = mesh_calls * SPMD_ARCH_BLOCKS * 4
        want = {"K1": n, "K2": n} if n else {}
        text = lambda c, n=n: (f"{c['K1']} K1 raw + {c['K2']} K2" if n else
                               "no kernel: the merged mesh_edges set is unfused, as in the JAX package")
        timings[arch] = check_case(
            f"{arch} 2x2", trainer, model, topo, static, state, frames, normal, hyper, (2, 2), None, tiered_ok, text,
            "graph rank 1's partials zeroed", want_step=want, want_fwd={"K1": n} if n else {})

    # the Ricci balancer on cylinder and plate as shipped, float32
    lo, hi = SPMD_MODELS_FRAMES
    for name in ("cylinder", "plate"):
        config = model_config(name)
        bal = config["params"]["model"]["graph_balancer"]
        bal["algorithm"] = "ricci"
        if (bal["ricci"]["loops"], bal["ricci"]["tau"], bal["remove_edges"], bal["frequency"]) != (150, 150, True, 1):
            raise AssertionError(f"configs/{name}.yaml's graph_balancer changed: {bal}")
        model = get_model(config)
        trainer = Trainer(model, config)
        traj = model_trajectory(name, seed, hi + 3)
        topo = model.topology_from_trajectory(traj, device="cuda")
        reset_counts()  # the trainer's prepare is on the main path: 2 K5 per SDRF loop
        t0 = time.perf_counter()
        static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        counts = read_counts()
        if counts != {**dict.fromkeys(counts, 0), "K5": 2 * sdrf.loops_run}:
            raise AssertionError(f"{name} balancer prepare: launches {counts}, want {2 * sdrf.loops_run} K5")
        launches["K5"] += counts["K5"]
        loops, removed = sdrf.loops_run, int((static[0].mesh_keep == 0).sum())
        state = capped(model_state(model, traj, seed))
        frames = {k: torch.as_tensor(v[lo:hi]).cuda() for k, v in traj.items() if k != "cells"}
        normal = torch.randn(frames[MODEL_FIELDS[name]].shape, generator=gen, device="cuda")
        blocks = model.gnn_config.message_passing_steps
        ok = models_ok
        text = lambda c: ", ".join(f"{c[k]} {k}" for k in ("K1", "K7", "K2") if c[k])
        timings[f"{name}+ricci 2x2"] = check_case(
            f"{name}+ricci 2x2", trainer, model, topo, static, state, frames, normal, None, (2, 2), None, ok, text,
            "graph rank 1's partials zeroed", want_step={"K1": blocks * 4, "K2": blocks * 4},
            want_fwd={"K1": blocks * 4})
        timings[f"{name}+ricci 2x2"].update(prepare_s=prepare_s, sdrf_loops=loops, removed_edges=removed,
                                            balance_edges=int(static[0].bal_mask.sum()))
        log(f"{name}+ricci: prepare {prepare_s:.3f} s, {loops} SDRF loops ({2 * loops} K5), {removed} mesh edges "
            f"removed, {int(static[0].bal_mask.sum())} balance edges [{card}]")
        if name == "cylinder":  # the round-robin layout: the keep mask laid out as the mesh edges lie
            half = {k: v[:8] for k, v in frames.items()}
            timings["cylinder+ricci 1x4 overlap"] = check_case(
                "cylinder+ricci 1x4 overlap", trainer, model, topo, static, state, half, normal[:8], None, (1, 4),
                HALO_BANDS, ok, text, "the keep mask in the unsharded order", fault_static=unsharded_keep,
                want_step={"K7": blocks * 4, "K2": blocks * 4})
    faulthandler.cancel_dump_traceback_later()
    log(f"spmd arch: {time.perf_counter() - t_phase:.1f} s, watchdog disarmed")
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
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    for fn in _counters().values():
        fn.launches = 0
    fb.fused_edge_block_bwd.tie_launches = 0


def read_counts():
    """Each kernel's launches since the last reset, and ``K2 tie``: K2's
    with a tie tolerance (the hybrid's), counted in ``K2`` too."""
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    return {**{k: fn.launches for k, fn in _counters().items()}, "K2 tie": fb.fused_edge_block_bwd.tie_launches}


# The balancer on the other paths and the random balancer, each at full
# width: cut to 1 + WARMUP_STEPS + TIMED_STEPS steps (no 30-step loss check)
# and held against the CPU in float32 only, for the script's time limit.
TRAIN_EXTRA_MODES = ("balancer_sorted", "balancer_gather", "random_balancer")


def random_balancer_config(**model):
    """``main_config`` with ``graph_balancer.algorithm: random`` (the file's
    100 pairs added and 100 removed, frequency 1)."""
    config = main_config(**model)
    bal = config["params"]["model"]["graph_balancer"]
    bal["algorithm"] = "random"
    if (bal["random"]["edge_amount"], bal["remove_edges"], bal["frequency"]) != (100, True, 1):
        raise AssertionError(f"flag_full_scale's graph_balancer changed: {bal}")
    return config


def phase_train(card, seed, profile_dir=None):
    """Train MGN-15MP through the port's Trainer with each backward: the
    fused path's remat (K2) and stream (K3), the sorted path (K4b), the
    fused remat path with the Ricci balancer (its prepare runs SDRF, K5),
    the balancer on the sorted (K4f/K4b) and gather (no kernel but K5) paths,
    and the random balancer (fused: K1/K2, no K5)."""
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
    for mode in ("remat", "stream", "sorted", "balancer") + TRAIN_EXTRA_MODES:
        agg_vjp = {"sorted": "sorted", "balancer_sorted": "sorted", "balancer_gather": "gather"}.get(mode, "fused")
        balancer = "balancer" in mode
        ricci = mode.startswith("balancer")
        bwd = "remat" if balancer else mode
        path = dict(agg_vjp=agg_vjp) if agg_vjp != "fused" else dict(fused_bwd=bwd)
        make_config = (balancer_config if ricci else random_balancer_config) if balancer else main_config
        config = make_config(**path)
        model = get_model(config)
        cfg = model.gnn_config
        check_mgn15(cfg, agg_vjp, balancer)
        if (agg_vjp == "fused" and cfg.fused_bwd != bwd) or model.noise_scale != 0.003 or model.noise_gamma != 0.9:
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
                  "balancer": ("K1", "K2"), "balancer_sorted": ("K4f", "K4b"), "balancer_gather": (),
                  "random_balancer": ("K1", "K2")}[mode]:
            want[k] = blocks
        if ricci:
            want["K5"] = 2 * sdrf.loops_run
        if counts != want:
            raise AssertionError(f"train step ({mode}) launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        log(f"train step ({mode}) launches: {counts}")

        # loss curve on one fixed batch, and the step's time
        if balancer:
            bstat = static[0]
            log(f"train step ({mode}): {int(bstat.bal_mask.sum())} balance edges, "
                f"{int((bstat.mesh_keep == 0).sum())} mesh edges removed")
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
        # balancer) static, B = CPU_FRAMES, PyTorch's scatter-adds in a fixed
        # order on both sides (see TRAIN_TOL)
        with fixed_scatter_order():
            for dtype_name in ("float32",) if mode in TRAIN_EXTRA_MODES else ("bfloat16", "float32"):
                cmp_config = make_config(**path, compute_dtype=None if dtype_name == "float32" else dtype_name)
                cmp_model = get_model(cmp_config)
                state = cmp_model.init_state(torch.Generator().manual_seed(seed + 1))
                small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
                normal = torch.randn(small["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 2),
                                     dtype=torch.float64)
                grads, losses_cmp = {}, {}
                cpu_key = (agg_vjp, mode if balancer else None, dtype_name)
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
                    raise AssertionError(
                        f"train step ({mode}) {dtype_name} card vs CPU outside {TRAIN_TOL[dtype_name]}: loss "
                        f"{loss_err:.3g}, worst gradients {sorted(errs.items(), key=lambda kv: -kv[1])[:4]}"
                    )
                timings[mode][f"vs_cpu_{dtype_name}"] = dict(
                    loss_rel=loss_err, worst_grad_rel_l2=worst[0], worst_balance_grad_rel_l2=worst_own[0]
                )
    return launches, timings


# The task's evaluator scalars on the card against the CPU, same state, bf16
# on both (relative difference): the one-step loss and error over the
# validation trajectory's 57 frames (K1 at B=21 and 15) and the n-step loss
# over 4 windows of 10 steps (one chunk: K1 at B=4; the task path's own
# chunk of 32 windows runs in its n-step evaluators above, and ran here
# until the CPU's 32 windows took most of the phase). The limits were set
# at about 10x the sound reading over 32 windows (7.4e-7, 5.4e-7, 2.5e-5
# on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md); over 4 windows the
# n-step reading is 1.1e-4 (the same in every run: the sums run in a fixed
# order). The check is run again with a K1 fault planted on the card
# (TASK_FAULTS; each reads 4.1e-3 or more on every scalar): the phase fails
# unless each fault breaks a limit.
TASK_TOL = {"validation_loss": 1e-5, "position_error": 1e-5, "n_step_loss": 2.5e-4}
TASK_CPU_TIMESTEPS = 14  # the n-step comparison's frames: 4 windows of 10 steps


def _toward_zero(x):
    """``x`` with every nonzero element one unit in the last place nearer 0."""
    import torch

    bits = x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
    return torch.where(x != 0, bits - 1, bits).view(x.dtype)


# Planted K1 faults: what a wrong kernel could get wrong without failing to
# run. ``e2_ulp``: the edge output rounded one bf16 unit toward zero (a
# rounding fault, at most one unit); ``lost_receivers``: every 64th
# receiver's aggregate left at zero (a work group not written).
def _fault_e2_ulp(e2, agg, *rest):
    return (_toward_zero(e2), agg, *rest)


def _fault_lost_receivers(e2, agg, *rest):
    agg = agg.clone()
    agg[:, ::64] = 0
    return (e2, agg, *rest)


TASK_FAULTS = {"e2_ulp": _fault_e2_ulp, "lost_receivers": _fault_lost_receivers}
CLI_CONFIG = "flag_fused_demo"
# The rollout and n-step evaluators under inference_quant: int8 on the task's
# state, the card against the CPU (relative difference of each scalar): the
# rollout over TASK_INT8_STEPS steps, the n-step loss over the comparison's 4
# windows of 10 steps.  Every dense product is exact on both, but an
# activation one rounding from a code boundary may take the other code on
# the other device (the phase_int8 note), so the scalars move as int8
# rounding does.  The limit is about 8x the sound reading (3.3e-5 to 2.5e-4
# on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md); the control, one weight
# code flipped (``_flip_one_code``), read 1.0e-2 to 2.1e-2 and must break a
# limit; the float evaluators read 4.5e-2 to 6.3e-2 off the CPU's int8.
TASK_INT8_STEPS = 20
TASK_INT8_TOL = dict.fromkeys(("rollout_loss", "rollout_loss_last", "n_step_loss", "n_step_last_loss"), 2e-3)


def task_config():
    """``main_config`` with the file's own task settings, checked."""
    config = main_config()
    task = config["params"]["task"]
    want = dict(batch_size=21, epochs=1, n_timesteps=57, trajectories=2)
    if {k: task[k] for k in want} != want or task["synthetic"] != dict(trajectories=2, num_steps=60, nx=40, ny=40) \
            or task["test"]["n_steps"] != 10:
        raise AssertionError(f"flag_full_scale's task settings changed: {task}")
    return config


def task_int8_evaluators(config, root, tstate, cpu_state, n_step):
    """The rollout and n-step evaluators of ``config`` with
    ``inference_quant: int8`` on ``tstate`` (the task's, on the card) and
    ``cpu_state`` (its copy on the CPU): the card's run with its launches
    and int8 products counted, the training state float and as it was
    after it, the scalars against the CPU's (TASK_INT8_TOL), again with one
    weight code flipped (which must break a limit), and the float
    evaluators' scalars on the card (context)."""
    import copy

    import torch

    from hyper_graph_nets_tpu_torch.data.loader import get_data
    from hyper_graph_nets_tpu_torch.nn import quant
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator

    float_config, config = config, copy.deepcopy(config)
    config["params"]["model"]["inference_quant"] = "int8"
    valid = lambda: get_data(config, "valid", data_dir=root)
    before = {n: p.detach().clone() for n, p in tstate.model.params.named_parameters()}

    def evaluate(sim, ts):
        out = sim.rollout_evaluator(ts, valid(), n_rollouts=1, num_steps=TASK_INT8_STEPS, logging=False,
                                    save=False)
        out.update(sim.n_step_evaluator(ts, valid(), n_step=n_step, n_trajectories=1,
                                        num_timesteps=TASK_CPU_TIMESTEPS, logging=False))
        return {k: out[k] for k in TASK_INT8_TOL}

    t0 = time.perf_counter()
    cpu = evaluate(MeshSimulator(config, out_dir=os.path.join(root, "int8_cpu"), device="cpu"), cpu_state)
    cpu_s = time.perf_counter() - t0
    sim = MeshSimulator(config, out_dir=os.path.join(root, "int8"))
    torch.cuda.synchronize()
    reset_counts()
    quant.int8_matmul.calls = 0
    t0 = time.perf_counter()
    got = evaluate(sim, tstate)
    torch.cuda.synchronize()
    card_s, launches, products = time.perf_counter() - t0, read_counts(), quant.int8_matmul.calls
    changed = [n for n, p in tstate.model.params.named_parameters()
               if p.dtype != torch.float32 or not torch.equal(p, before[n])]
    rel = lambda out: {k: abs(out[k] - cpu[k]) / abs(cpu[k]) for k in TASK_INT8_TOL}
    errs = rel(got)

    probe = Predictor(config, state=tstate.model)
    frames = {k: v[:CPU_FRAMES] for k, v in next(iter(valid())).items()}
    flipped_state = _flip_one_code(probe, frames)
    sim.model.inference_state = lambda state: flipped_state
    try:
        flipped = rel(evaluate(sim, tstate))
    finally:
        del sim.model.inference_state
    floats = rel(evaluate(MeshSimulator(float_config, out_dir=os.path.join(root, "float")), tstate))
    log(f"task int8 evaluators: card {got} in {card_s:.1f} s ({products} int8 products, launches {launches}), "
        f"CPU {cpu} in {cpu_s:.1f} s; card vs CPU (relative; limits {TASK_INT8_TOL}): {errs}; with the "
        f"flipped code {flipped}; the float evaluators vs the CPU's int8 (context) {floats}")
    if any(launches.values()) or not products:
        raise AssertionError(f"task int8 evaluators launched {launches}, {products} int8 products")
    if changed:
        raise AssertionError(f"task int8 evaluators changed the training state: {changed[:4]}")
    if any(errs[k] > TASK_INT8_TOL[k] for k in TASK_INT8_TOL):
        raise AssertionError(f"task int8 evaluators card vs CPU outside {TASK_INT8_TOL}: {errs}")
    if not any(flipped[k] > TASK_INT8_TOL[k] for k in TASK_INT8_TOL):
        raise AssertionError(f"task int8 evaluators: the flipped code passed the check: {flipped}")
    return dict(card=got, cpu=cpu, vs_cpu=errs, flipped_code_vs_cpu=flipped, float_vs_cpu_int8=floats,
                card_s=card_s, cpu_s=cpu_s, int8_products=products)


def phase_task(card):
    """The task loop on the card: ``get_task(flag_full_scale, RMP off)``,
    ``run_iterations`` (fit over 2 trajectories, the three evaluators on the
    validation split, GIF, checkpoint) and ``get_scalars`` (the evaluators on
    the test split), with the launches read around fit and each evaluator;
    a second task resuming from the checkpoint; ``Predictor`` served from
    the checkpoint; the evaluators' scalars against the CPU, float and
    int8 (``task_int8_evaluators``; the CLI on configs/flag_fused_demo.yaml
    is in ``phase_cli``)."""
    import tempfile

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data import tfrecord
    from hyper_graph_nets_tpu_torch.data.loader import get_data
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training import checkpoint
    from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
    from hyper_graph_nets_tpu_torch.training.task import get_task
    from hyper_graph_nets_tpu_torch.training.trainer import TrainState

    config = task_config()
    params = config["params"]
    B, T, n = params["task"]["batch_size"], params["task"]["n_timesteps"], params["task"]["test"]["n_steps"]
    timings = {}
    with tempfile.TemporaryDirectory(prefix="hgn_task_") as root:
        t0 = time.perf_counter()
        for split in ("train", "valid", "test"):
            get_data(config, split, data_dir=root)
        timings["data_s"] = time.perf_counter() - t0
        synth = params["task"]["synthetic"]
        log(f"task: synthetic {params['task']['dataset']} {synth['nx']}x{synth['ny']} written and read in "
            f"{timings['data_s']:.2f} s (CRC32C: {tfrecord.crc32c_backend()})")
        task = get_task(config, data_dir=root)
        sim = task.simulator
        blocks = sim.model.gnn_config.message_passing_steps
        check_mgn15(sim.model.gnn_config)

        # each phase's launches, seconds and K1's batch sizes
        calls = {name: [] for name in ("fit", "one_step", "rollout", "n_step")}
        batches = []
        k1 = fb.fused_edge_block_fwd

        def recorded_k1(e, *args, **kwargs):
            batches.append(e.shape[0])
            return k1(e, *args, **kwargs)

        def counted(name, fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                before, b0, t0 = read_counts(), len(batches), time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                after = read_counts()
                calls[name].append(dict(
                    launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                    s=time.perf_counter() - t0, batches=sorted(set(batches[b0:])),
                ))
                return out
            return run

        for name in calls:
            attr = "fit_trajectory" if name == "fit" else f"{name}_evaluator"
            setattr(sim, attr, counted(name, getattr(sim, attr)))

        # the main path: every count set to 0 just before, read just after
        fb.fused_edge_block_fwd = recorded_k1
        try:
            reset_counts()
            t0 = time.perf_counter()
            task.run_iterations()
            torch.cuda.synchronize()
            timings["epoch_s"] = time.perf_counter() - t0
            scalars = task.get_scalars()
            launches = read_counts()
        finally:
            fb.fused_edge_block_fwd = k1
        log(f"task launches: {launches}; scalars {scalars}")

        windows = T - n
        chunk = sim.model.n_step_chunk_size(windows)
        want_each = {
            "fit": {"K1": blocks * -(-T // B), "K2": blocks * -(-T // B)},
            "one_step": {"K1": blocks * -(-T // B)},
            "rollout": {"K1": blocks * T},
            "n_step": {"K1": blocks * n * -(-windows // chunk)},
        }
        want_batches = {"fit": [T % B, B], "one_step": [T % B, B], "rollout": [1],
                        "n_step": sorted({chunk, windows % chunk or chunk})}
        want_calls = {"fit": params["task"]["trajectories"], "one_step": 2, "rollout": 2, "n_step": 2}
        for name, runs in calls.items():
            log(f"task {name}: " + "; ".join(
                f"{r['launches']} in {r['s']:.3f} s, B {r['batches']}" for r in runs))
            if len(runs) != want_calls[name] or any(
                r["launches"] != want_each[name] or r["batches"] != want_batches[name] for r in runs
            ):
                raise AssertionError(f"task {name}: {runs}, want {want_calls[name]} x {want_each[name]} "
                                     f"at B {want_batches[name]}")
        want = dict.fromkeys(launches, 0)
        for name, runs in calls.items():
            for k, v in want_each[name].items():
                want[k] += v * len(runs)
        if launches != want:
            raise AssertionError(f"task launches {launches}, want {want}")
        if not all(np.isfinite(v) for v in scalars.values()) or len(scalars) != 4:
            raise AssertionError(f"task scalars not finite: {scalars}")
        ckpt = os.path.join(task.out_dir, checkpoint.checkpoint_name(config, 1))
        if not os.path.isfile(ckpt):
            raise AssertionError(f"no checkpoint at {ckpt}")
        with open(os.path.join(task.out_dir, "run.metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        fit_rate = [r["edges_per_s"] for r in records if "edges_per_s" in r]
        timings.update(
            scalars=scalars, launches=launches,
            calls={k: [dict(r, launches=dict(r["launches"])) for r in v] for k, v in calls.items()},
            fit_edges_per_s=fit_rate,
            rollout_ms_per_step=[1e3 * r["s"] / T for r in calls["rollout"]],
            n_step_s=[r["s"] for r in calls["n_step"]],
        )

        # a second task on the same directory resumes and trains nothing
        reset_counts()
        again = get_task(config, data_dir=root)
        again.run_iterations()
        torch.cuda.synchronize()
        resumed = read_counts()
        if again.start_epoch != 1 or any(resumed.values()):
            raise AssertionError(f"resume: start epoch {again.start_epoch}, launches {resumed}")
        log(f"task resumed at epoch {again.start_epoch} (step {again.tstate.step}); launches {resumed}")

        # serving from the checkpoint: bit for bit the task's own state
        test = next(iter(get_data(config, "test", data_dir=root)))
        batch = {k: v[:B] for k, v in test.items()}
        served = Predictor.from_config(config, checkpoint=task.out_dir).one_step(batch)
        direct = Predictor(config, state=task.tstate.model).one_step(batch)
        if not np.array_equal(served, direct):
            raise AssertionError("Predictor from the checkpoint differs from the task's state")
        log("Predictor.from_config(checkpoint=...).one_step equals the task state's bit for bit")

        # the evaluators on the card against the CPU, same state; then on the
        # card again with each planted K1 fault, which the check must catch
        cpu_sim = MeshSimulator(config, out_dir=os.path.join(root, "cpu"), device="cpu")
        cpu_state = TrainState(model=task.tstate.model.to("cpu"), opt_state=None, step=task.tstate.step)

        def evaluate(where, s, ts):
            valid = lambda: get_data(config, "valid", data_dir=root)
            del batches[:]
            t0 = time.perf_counter()
            out = s.one_step_evaluator(ts, valid(), n_trajectories=1, logging=False)
            out.update(s.n_step_evaluator(ts, valid(), n_step=n, n_trajectories=1,
                                          num_timesteps=TASK_CPU_TIMESTEPS, logging=False))
            log(f"task evaluators on {where}: {out} in {time.perf_counter() - t0:.1f} s, "
                f"K1 at B {sorted(set(batches))}")
            return out

        cpu = evaluate("cpu", cpu_sim, cpu_state)
        rel = lambda out: {k: abs(out[k] - cpu[k]) / abs(cpu[k]) for k in TASK_TOL}
        fb.fused_edge_block_fwd = recorded_k1
        try:
            errs = rel(evaluate("cuda", sim, task.tstate))
            card_batches = sorted(set(batches))
            faults = {}
            for fault, plant in TASK_FAULTS.items():
                fb.fused_edge_block_fwd = lambda *a, plant=plant, **kw: plant(*recorded_k1(*a, **kw))
                faults[fault] = rel(evaluate(f"cuda with fault {fault}", sim, task.tstate))
        finally:
            fb.fused_edge_block_fwd = k1
        log(f"task evaluators card vs CPU (relative; limits {TASK_TOL}): {errs}")
        for fault, e in faults.items():
            log(f"task evaluators card with K1 fault {fault} vs CPU (relative): {e}")
        timings["vs_cpu"], timings["vs_cpu_faults"] = errs, faults
        if card_batches != sorted({TASK_LAST_BATCH, B, min(TASK_N_STEP_CHUNK, TASK_CPU_TIMESTEPS - n)}):
            raise AssertionError(f"task evaluators card vs CPU ran K1 at B {card_batches}")
        if any(errs[k] > TASK_TOL[k] for k in TASK_TOL):
            raise AssertionError(f"task evaluators card vs CPU outside {TASK_TOL}: {errs}")
        caught = {f: any(e[k] > TASK_TOL[k] for k in TASK_TOL) for f, e in faults.items()}
        if not all(caught.values()):
            raise AssertionError(f"task evaluators card vs CPU: a planted K1 fault passed the check: {faults}")
        timings["int8"] = task_int8_evaluators(config, root, task.tstate, cpu_state, n)

    log(f"task epoch (fit + validation evaluators + GIF + checkpoint): {timings['epoch_s']:.3f} s; "
        f"fit edges/s (logger, per trajectory) {', '.join(f'{r:.4g}' for r in fit_rate)} [{card}]")
    log(f"task rollout evaluator: {', '.join(f'{r:.2f}' for r in timings['rollout_ms_per_step'])} ms/step "
        f"(B=1, {T} steps); n-step evaluator {', '.join(f'{r:.3f}' for r in timings['n_step_s'])} s "
        f"({windows} windows of {n} steps, chunks of {chunk}) [{card}]")
    return launches, timings


# -- remote message passing: configs/flag_full_scale.yaml as shipped ----------

RMP_CLUSTERS = 16  # and so 1,616 rows on the 40x40 flag: 1,600 mesh rows, 16 hyper rows
# the RMP rollout's steps: cut from ROLLOUT_STEPS (50) for the script's time
# limit; its ms per step is a mean over them
RMP_ROLLOUT_STEPS = 20
# The RMP train step's loss and gradients and its one_step output on the
# card against the CPU (same converted state, noise and static, B = 2
# frames, 15 hierarchical blocks): loss relative error, each gradient's
# relative L2 (``grad`` for the mesh tier, the encoders, decoder and mesh
# node models; ``tier_grad`` for the cluster tier, RMP_TIER: the hyper
# encoder and node models and the up, inter and down edge models, each fed
# by the B x 16 hyper rows.  Their float32 errors are lumpy where the mesh
# tier's are not: tools/torch_port/rmp_tier_spread.py read the cluster
# tier's worst from 1.2e-4 to 3.4e-3 over frame and cluster counts, one
# tensor at a time, and the mesh tier's 0.8e-4 to 2.2e-4; PERF.md section
# 6), and the one_step accelerations' largest error over their largest
# magnitude.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), the same
# on every run since the train step is bit for bit: bf16 loss 1.9e-5,
# cluster tier 0.073, accelerations 8.7e-3; float32 loss 7.2e-8, cluster
# tier 1.4e-3, accelerations 6.5e-4.  Each run also plants K1 faults
# (TASK_FAULTS), each of which must break one limit: in bf16 both (e2_ulp
# read 0.161 on a mesh-tier tensor); in float32 the lost receivers (one
# float32 unit in the last place of e2 sits inside the summation-order
# differences the limits allow).
RMP_FAULTS = {"bfloat16": ("e2_ulp", "lost_receivers"), "float32": ("lost_receivers",)}
RMP_TIER = ("hyper_", "inter_cluster", "intra_cluster_to_cluster", "intra_cluster_to_mesh")
# Planted faults in a cluster-tier set: ``tier_drop``, one
# intra_cluster_to_mesh edge dropped (mesh row 5 gets no message from its
# cluster), in both types; ``tier_cluster_drop``, every such edge of that
# edge's cluster dropped, in bf16.  One of them must break the cluster
# tier's own limit (``tier_grad``, RMP_TIER_CONTROL): the control that the
# looser tier limit can fail a wrong tier path.  In float32 the one edge
# reads 2.74e-2 on the tier (on the CPU, sound against faulted: 2.7e-2).
# In bf16 it reads 0.066 on the tier, under the sound run's own 0.073 (bf16
# rounding of the cluster means, which a tier limit cannot tell from it),
# and breaks the accelerations' limit (0.043); the cluster's edges read
# 0.182.  So the bf16 tier limit went from 0.25 to 0.12, 1.65x the sound
# reading and 1.5x under the cluster fault's (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6, HGN plate findings; the train step is bit for bit, so
# each reading is the same on every run of this code).  And one bisection step of the
# tier's card-CPU spread: the card run again with the CPU's expand outputs
# (hyper features and the tier sets' features) fed in, a sound run held to
# the same limits.
RMP_TIER_FAULT_EDGE = 5
RMP_TIER_CONTROL = {"float32": "tier_drop", "bfloat16": "tier_cluster_drop"}
RMP_TOL = {
    "float32": {"loss": 1e-6, "grad": 1e-3, "tier_grad": 1e-2, "acceleration": 5e-3},
    "bfloat16": {"loss": 2e-4, "grad": 2.0**-4, "tier_grad": 0.12, "acceleration": 0.02},
}
RMP_CLI_CONFIG = "flag_full_scale"


def rmp_config(**model):
    """configs/flag_full_scale.yaml as shipped (RMP on), its RMP settings
    checked; ``model`` overrides keys of the model section."""
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml("flag_full_scale")
    rmp = config["params"]["model"]["rmp"]
    want = dict(clustering="spectral", connector="hyper", num_clusters=RMP_CLUSTERS, hyper_noise=0.005,
                frequency=1, hyper_node_features=True)
    if {k: rmp.get(k) for k in want} != want or rmp["intra_cluster_sampling"]["enabled"]:
        raise AssertionError(f"flag_full_scale's rmp settings changed: {rmp}")
    config["params"]["model"].update(model)
    return config


def check_rmp(cfg, compute_dtype="bfloat16"):
    got = (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp, cfg.fused_bwd, cfg.compute_dtype,
           cfg.architecture)
    if got != (128, 15, "fused", "remat", compute_dtype, "hyper"):
        raise AssertionError(f"flag_full_scale is not HGN-15MP fused remat {compute_dtype}: {cfg}")
    sets = ("mesh_edges", "intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster")
    if cfg.edge_sets != sets:
        raise AssertionError(f"edge sets {cfg.edge_sets}, want {sets}")


def rmp_state(config, traj, seed):
    """Seeded weights (CPU) whose normalizers, the RMP ones included, have
    seen the trajectory in training mode (one clustering, seeded noise)."""
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

    model = get_model(config)
    exp = build_expansion(model, config)
    state = model.init_state(torch.Generator().manual_seed(seed))
    topo = model.topology_from_trajectory(traj, device="cpu")
    static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    with torch.no_grad():
        graph, _, state = model.make_graph(state, topo, frames, True)
        _, state = exp.expand(state, graph, frames, model, True, static=static,
                              generator=torch.Generator().manual_seed(seed + 3))
        _, state = model.get_target(state, frames, True)
    return state


def _host_ms(fn, n):
    import numpy as np
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _rmp_kernels(card, peaks, static, snd, rcv, N, seed):
    """K1 and K2 on the mesh set over the N + K rows of the RMP path (the
    hyper rows receive no edge), at B = 21 in bf16, against their plain
    versions."""
    rows = N + RMP_CLUSTERS
    plan = static.mesh_plan
    if plan is None or plan.num_nodes != rows:
        raise AssertionError(f"the RMP mesh plan covers {None if plan is None else plan.num_nodes} rows, want {rows}")
    return planned_kernels(card, peaks, plan, snd, rcv, rows, TRAIN_FRAMES, "bfloat16", seed + 5,
                           "RMP mesh set")


def planned_kernels(card, peaks, plan, snd, rcv, rows, B, dtype_name, seed, tag, mask=None):
    """K1 and K2 with a topology's own plan at the path's shapes (``rows``
    node rows, ``B`` frames, latent 128; ``mask`` the set's edge mask, None:
    all valid) against their plain versions, each timed beside its bound and
    plain time.  A row that receives no valid edge (RMP's hyper rows in the
    mesh set, plate's obstacle nodes, the mesh rows of an up set) must
    aggregate to 0 and get no receiver cotangent, and a row that sends none
    no sender cotangent, whatever the masked tail of a valid-prefix plan
    names."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.ops.fused_block import (
        agg_cotangent_rhs,
        fused_edge_block,
        fused_edge_block_bwd,
        fused_edge_block_bwd_reference,
        fused_edge_block_fwd,
        fused_edge_block_reference,
    )

    L, E, dtype = L_MAIN, len(snd), getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(seed)
    x = k1_inputs(dtype, B, snd, rcv, rows, L, gen, "cuda", mask=mask)
    valid = np.ones(E, bool) if mask is None else np.asarray(mask) > 0
    no_recv = torch.as_tensor(np.bincount(rcv[valid], minlength=rows) == 0, device="cuda")
    no_send = torch.as_tensor(np.bincount(snd[valid], minlength=rows) == 0, device="cuda")
    f32 = dtype_name == "float32"
    wide = lambda: dict(x, **{k: x[k].double() for k in ("e", "sp", "rp")})
    run = lambda: fused_edge_block(**x, plan=plan)
    e2, agg = run()
    torch.cuda.synchronize()
    re2, ragg = fused_edge_block_reference(**x)
    err = max(check_close(f"K1 {tag} e2", e2, re2, *TOL[dtype_name]["e2"]),
              check_close(f"K1 {tag} agg", agg, ragg, *TOL[dtype_name]["agg"]))
    if not bool((agg[:, no_recv] == 0).all()):
        raise AssertionError(f"K1 ({tag}): a row without valid edges has a non-zero aggregate")
    out = {}
    f64 = {}
    if f32:
        e2_64, agg_64 = fused_edge_block_reference(**wide())
        f64 = hold_to_f64(f"K1 {tag}", {"e2": (e2, re2, e2_64)})
        del e2_64, agg_64
    ms = kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
    plain_ms = cuda_time_ms(lambda: fused_edge_block_reference(**x), iters=10)
    bound, bound_by = k1_bound_ms(dtype_name, B, E, rows, L, peaks)
    out["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    if f32:
        out["K1"].update(f64_errors=f64)
    log(f"K1 {dtype_name} B={B} E={E} rows={rows} ({tag}): kernel {ms * 1e3:.1f} us, bound "
        f"{bound * 1e3:.2f} us ({bound_by}), plain {plain_ms:.3f} ms, max abs err {err:.3g}"
        + (f"; against float64: {f64_text(f64)}" if f32 else "") + f" [{card}]")

    topo = (x["senders"], x["receivers"], x["mask"], rows)
    fwd = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], x["weights"], *topo, plan=plan, save_streams=True)
    de2 = torch.randn(B, E, L, generator=gen).to(dtype).cuda()
    dagg = torch.randn(B, rows, 4 * L, generator=gen).cuda()
    drhs = agg_cotangent_rhs(fwd[1], dagg, x["receivers"], x["mask"], rows)
    k2 = lambda: fused_edge_block_bwd(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo, plan=plan)
    got = k2()
    torch.cuda.synchronize()
    want = fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo,
                                          forward=(fwd[0], fwd[2], fwd[3]))
    err = compare_bwd(f"K2 {tag}", dtype_name, got[:4] + got[6:], want[:4] + want[6:])
    if not (bool((got[6][:, no_send] == 0).all()) and bool((got[7][:, no_recv] == 0).all())):
        raise AssertionError(f"K2 ({tag}): a row without valid edges has a non-zero dsp/drp")
    if not (torch.equal(got[4], fwd[2]) and torch.equal(got[5], fwd[3])):
        raise AssertionError(f"K2 ({tag}): the recomputed a1/a2 differ from K1's")
    f64 = {}
    if f32:
        w64 = wide()
        want64 = fused_edge_block_bwd_reference(w64["e"], w64["sp"], w64["rp"], x["weights"], de2.double(), drhs,
                                                *topo, forward=(fwd[0], fwd[2], fwd[3]))
        f64 = hold_to_f64(f"K2 {tag}", {n: (got[i], want[i], want64[i]) for i, n in enumerate(("de", "dh", "dz2",
                                                                                            "dz3"))})
        del w64, want64
    ms = kernel_device_ms(k2, iters=10, names=BWD_KERNELS)
    plain_ms = cuda_time_ms(
        lambda: fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], x["weights"], de2, drhs, *topo),
        iters=5,
    )
    bound, bound_by = bwd_bound_ms(dtype_name, B, E, rows, L, peaks, stream=False)
    out["K2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    if f32:
        out["K2"].update(f64_errors=f64)
    log(f"K2 {dtype_name} B={B} E={E} rows={rows} ({tag}): kernels {ms * 1e3:.1f} us, bound "
        f"{bound * 1e3:.2f} us ({bound_by}), plain {plain_ms:.3f} ms, max abs err {err:.3g}"
        + (f"; against float64: {f64_text(f64)}" if f32 else "") + f" [{card}]")
    return out


def _train_twice(trainer, state, topo, frames, static, normal, hyper):
    """Two loss_and_grads from the same state, noise and static, outside any
    deterministic-algorithms setting: (loss, gradients, normalizer fields)
    of each."""
    import torch

    runs = []
    for _ in range(2):
        ts = trainer.init_train_state(state=state)
        loss, norms = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        torch.cuda.synchronize()
        runs.append((loss.cpu(), [p.grad.cpu() for p in ts.model.params.parameters()],
                     [getattr(ns, f).cpu() for ns in norms.values() for f in ("acc_sum", "acc_sum_squared")]))
    return runs


def _bit_for_bit(tag, runs):
    import torch

    (l0, g0, n0), (l1, g1, n1) = runs
    same = torch.equal(l0, l1) and all(map(torch.equal, g0, g1)) and all(map(torch.equal, n0, n1))
    differ = sum(not torch.equal(a, b) for a, b in zip(g0, g1))
    log(f"train step ({tag}) twice from one state and noise, no deterministic-algorithms setting: "
        f"loss {float(l0):.8f} / {float(l1):.8f}; {len(g0) - differ} of {len(g0)} gradients bit for bit")
    if not same:
        raise AssertionError(f"train step ({tag}) is not the same bit for bit on a second run ({differ} "
                             "gradients differ)")


def rmp_runs(config, state, small, static, normal, hyper, wheres, card_device="cuda"):
    """The RMP train step's loss and gradients and one_step's accelerations
    on ``small``'s frames from one state, noise draw and static: ``{where:
    (loss, gradients, accelerations)}`` on the CPU and at each of ``wheres``
    on the card: ``card``; ``card cpu_expand``, fed the CPU's expand outputs
    (a bisection step); ``card tier_drop``, one intra_cluster_to_mesh edge
    (RMP_TIER_FAULT_EDGE) dropped; ``card tier_cluster_drop``, every such
    edge of that edge's cluster dropped; ``card <fault>``, a K1 fault of
    TASK_FAULTS planted."""
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    model = get_model(config)
    base = 2 * small["world_pos"] - small["prev|world_pos"]
    tier_sets = ("intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster")
    runs, expanded = {}, {}
    k1 = fb.fused_edge_block_fwd
    for where in ("cpu", *wheres):
        device = "cpu" if where == "cpu" else card_device
        tr = Trainer(model, config, device=device)
        topo = model.topology_from_trajectory(small, device=device)
        st = tuple(x.to(device) for x in static)
        expand = tr.expansion.expand
        if where == "cpu":
            tr.expansion.expand = lambda *a, **kw: _recorded(expand(*a, **kw), expanded, tier_sets)
        elif where == "card cpu_expand":
            tr.expansion.expand = lambda *a, **kw: _fed(expand(*a, **kw), expanded, device)
        elif where == "card tier_drop":
            st = st[:-1] + (_drop_down_edges(st[-1], [RMP_TIER_FAULT_EDGE]),)
        elif where == "card tier_cluster_drop":
            cluster = st[-1].down_senders == st[-1].down_senders[RMP_TIER_FAULT_EDGE]
            st = st[:-1] + (_drop_down_edges(st[-1], torch.nonzero(cluster).flatten().tolist()),)
        elif where != "card":
            plant = TASK_FAULTS[where.split()[1]]
            fb.fused_edge_block_fwd = lambda *a, plant=plant, **kw: plant(*k1(*a, **kw))
        try:
            ts = tr.init_train_state(state=state)
            loss, _ = tr.loss_and_grads(ts, topo, tr.frames(small), normal=normal.to(device), static=st,
                                        hyper_normal=hyper.to(device))
            grads = {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()}
            pred = Predictor(config, state=state, device=device).one_step(small, static=st)
        finally:
            fb.fused_edge_block_fwd = k1
        runs[where] = (float(loss), grads, pred - base)
    return runs


def rmp_vs_cpu(traj, small, normal, hyper, seed, card_device):
    """The RMP train step's loss and gradients and one_step's accelerations
    on the card against the CPU (``small``: B = CPU_FRAMES frames; the same
    converted state, noise and static), in bf16 and float32, and again on
    the card with each planted K1 fault of RMP_FAULTS and each tier fault
    (``tier_drop``; in bf16 ``tier_cluster_drop``).  Returns ``(sound,
    faulted)``: ``{"<dtype> <where>": {limit: reading}}``."""
    import numpy as np

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    frame0 = {k: v[0] for k, v in traj.items()}
    in_tier = lambda n: any(tag in n for tag in RMP_TIER)
    vs_cpu, faults = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        cfg = rmp_config(compute_dtype=None if dtype_name == "float32" else dtype_name)
        cmodel = get_model(cfg)
        check_rmp(cmodel.gnn_config, None if dtype_name == "float32" else dtype_name)
        cstate = rmp_state(cfg, traj, seed + 1)
        topo = cmodel.topology_from_trajectory(small, device="cpu")
        static = Trainer(cmodel, cfg, device="cpu").expansion.prepare(cmodel, frame0, topo)
        tier_runs = ("card tier_drop", "card cpu_expand" if dtype_name == "float32" else "card tier_cluster_drop")
        runs = rmp_runs(cfg, cstate, small, static, normal, hyper,
                        ("card", *(f"card {f}" for f in RMP_FAULTS[dtype_name]), *tier_runs), card_device)
        lc, gc, ac = runs["cpu"]
        for where, (l, g, a) in runs.items():
            if where == "cpu":
                continue
            errs = sorted(((rel_l2(g[n], gc[n]), n) for n in gc), reverse=True)
            rest = [e for e in errs if not in_tier(e[1])]
            tier = [e for e in errs if in_tier(e[1])]
            out = dict(loss=abs(l - lc) / abs(lc), grad=rest[0][0], tier_grad=tier[0][0],
                       acceleration=float(np.abs(a - ac).max() / np.abs(ac).max()))
            top = lambda es: ", ".join(f"{e:.3g} {n}" for e, n in es[:4])
            log(f"rmp {dtype_name} {where} vs CPU, B={CPU_FRAMES}: loss rel {out['loss']:.3g}; one_step acceleration "
                f"{out['acceleration']:.3g}; worst gradients (relative L2) {top(rest)}; of the cluster tier "
                f"{top(tier)} (limits {RMP_TOL[dtype_name]})")
            sound = where in ("card", "card cpu_expand")
            (vs_cpu if sound else faults)[f"{dtype_name} {where}"] = out
    return vs_cpu, faults


def _recorded(result, store, tier_sets):
    """An expand's ``(graph, state)``, its hyper features and tier-set
    features kept in ``store``."""
    graph, _ = result
    store["hyper"] = graph.hyper_features.detach()
    store.update({n: graph.edge_sets[n].features.detach() for n in tier_sets})
    return result


def _fed(result, store, device):
    """An expand's ``(graph, state)`` with the stored (CPU) hyper features
    and tier-set features in place of its own."""
    graph, state = result
    sets = dict(graph.edge_sets)
    for name, f in store.items():
        if name != "hyper":
            sets[name] = sets[name].replace(features=f.to(device))
    return graph.replace(edge_sets=sets, hyper_features=store["hyper"].to(device)), state


def _drop_down_edges(rstat, edges):
    """The RMP static with the intra_cluster_to_mesh ``edges`` dropped:
    masked, and gone from the receivers' neighbour matrix."""
    mask = rstat.down_mask.clone()
    gidx, gvalid = rstat.down_gather
    for j in edges:
        mask[j] = 0
        gvalid = gvalid.masked_fill(gidx == j, 0)
    return rstat._replace(down_mask=mask, down_gather=(gidx, gvalid))


def phase_rmp(card, peaks, seed, profile_dir=None):
    """The RMP path of configs/flag_full_scale.yaml as shipped: serving and
    training through Predictor and Trainer (15 K1 per forward, 15 K2 per
    train step), K1/K2 over the 1,616 rows against their plain versions,
    two train steps bit for bit (RMP and the balancer path), the card
    against the CPU with planted K1 faults (its CLI run is in ``phase_cli``)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    import importlib.util

    found = importlib.util.find_spec("sklearn") is not None
    log(f"rmp: scikit-learn is {'' if found else 'not '}installed on this machine; the port does not use it")
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("deterministic algorithms are on before the RMP phase")

    config = rmp_config()
    traj = add_targets(flag_trajectory(num_steps=ROLLOUT_STEPS + 3, nx=40, ny=40, seed=seed), "world_pos",
                       history=True)
    predictor = Predictor.from_config(config)
    model = predictor.model
    check_rmp(model.gnn_config)
    blocks = model.gnn_config.message_passing_steps
    state = rmp_state(config, traj, seed)
    predictor.state = state.to(predictor.device)
    B = ONE_STEP_FRAMES
    batch = {k: v[:B] for k, v in traj.items()}
    log(f"rmp serving: flag HGN-15MP as shipped (spectral, {RMP_CLUSTERS} clusters, connector hyper, latent 128, "
        f"bf16, fused remat), one_step B={B}, rollout {RMP_ROLLOUT_STEPS}")

    # serving, the main path: counts set to 0 just before, read just after
    reset_counts()
    pred = predictor.one_step(batch)
    one = read_counts()
    result = predictor.rollout(traj, num_steps=RMP_ROLLOUT_STEPS)
    serve = read_counts()
    want = dict.fromkeys(serve, 0)
    want["K1"] = blocks * (1 + RMP_ROLLOUT_STEPS)
    if one["K1"] != blocks or serve != want:
        raise AssertionError(f"rmp serving launches {one} in one_step, {serve} in all; want {want}")
    static = predictor.expansion.static
    rstat = static[0]
    if rstat.num_clusters != RMP_CLUSTERS or int((rstat.sizes > 0).sum()) != RMP_CLUSTERS:
        raise AssertionError(f"rmp static: {rstat.num_clusters} clusters, sizes {rstat.sizes.tolist()}")
    N = predictor._topology(traj).num_nodes
    if pred.shape != (B, N, 3) or not np.isfinite(pred).all():
        raise AssertionError(f"rmp one_step output {pred.shape} not finite/shaped")
    if result["pred_pos"].shape != (RMP_ROLLOUT_STEPS, N, 3) or not np.isfinite(result["mse"]).all():
        raise AssertionError("rmp rollout output not finite/shaped")
    log(f"rmp serving launches: {one['K1']} K1 per one_step, {serve} in all; {int(rstat.inter_mask.sum())} "
        f"inter-cluster edges, cluster sizes {sorted(int(s) for s in rstat.sizes.tolist())}")
    E = int(predictor._topology(traj).senders.shape[0])
    frame0 = {k: v[0] for k, v in traj.items()}

    def prepare():
        predictor.expansion.reset(0, 1)
        predictor.expansion.prepare(model, frame0, predictor._topology(traj))

    timings = dict(
        one_step_ms=_host_ms(lambda: predictor.one_step(batch), 5),
        one_step_static_ms=_host_ms(lambda: predictor.one_step(batch, static=static), 5),
        prepare_s=_host_ms(prepare, 5) / 1e3,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.rollout(traj, num_steps=RMP_ROLLOUT_STEPS)
    timings["rollout_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / RMP_ROLLOUT_STEPS
    timings["one_step_edges_per_s"] = B * E / (timings["one_step_static_ms"] / 1e3)
    log(f"rmp one_step B={B}: {timings['one_step_ms']:.2f} ms with its prepare, {timings['one_step_static_ms']:.2f} "
        f"ms with a prepared static ({timings['one_step_edges_per_s']:.4g} edges/s) [{card}]")
    log(f"rmp prepare (spectral clustering into {RMP_CLUSTERS}, static, fixed-order sums, mesh plan over "
        f"{N + RMP_CLUSTERS} rows), on every serving call: {timings['prepare_s']:.4f} s [{card}]")
    log(f"rmp rollout: {timings['rollout_ms_per_step']:.2f} ms/step with one prepare, "
        f"{E / (timings['rollout_ms_per_step'] / 1e3):.4g} edges/s [{card}]")

    snd = predictor._topology(traj).senders.cpu().numpy()
    rcv = predictor._topology(traj).receivers.cpu().numpy()
    kernels = _rmp_kernels(card, peaks, rstat, snd, rcv, N, seed)

    # training, the main path
    trainer = Trainer(model, config)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames({k: v[:TRAIN_FRAMES] for k, v in traj.items()})
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tstate = trainer.init_train_state(state=state)
    reset_counts()
    tstatic = trainer.expansion.prepare(model, frame0, topo)
    tstate, loss = trainer.train_step(tstate, topo, frames, generator=gen, static=tstatic)
    torch.cuda.synchronize()
    train = read_counts()
    want = dict.fromkeys(train, 0)
    want["K1"] = want["K2"] = blocks
    if train != want:
        raise AssertionError(f"rmp train step launches {train}, want {want}")
    log(f"rmp train step launches (prepare + one step): {train}")
    losses, step_s = [float(loss)], []
    for _ in range(LOSS_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstate, loss = trainer.train_step(tstate, topo, frames, generator=gen, static=tstatic)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rmp loss did not fall over {LOSS_STEPS} steps: {losses}")
    ms = 1e3 * float(np.median(step_s[WARMUP_STEPS : WARMUP_STEPS + TIMED_STEPS]))
    timings.update(train_step_ms=ms, train_edges_per_s=TRAIN_FRAMES * E / (ms / 1e3),
                   first_loss=losses[0], last_loss=losses[-1], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"rmp train step B={TRAIN_FRAMES}: {ms:.2f} ms (median of {TIMED_STEPS} after {WARMUP_STEPS} warm-up), "
        f"{timings['train_edges_per_s']:.4g} edges/s; loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
        f"{LOSS_STEPS} steps [{card}]")
    if profile_dir:
        timings["profile"] = {
            "one_step": device_profile(lambda: predictor.one_step(batch, static=static), card, profile_dir,
                                       "one_step_rmp"),
            "rollout_5_steps": device_profile(lambda: predictor.rollout(traj, num_steps=5, static=static), card,
                                              profile_dir, "rollout_rmp"),
            "train": device_profile(lambda: trainer.train_step(tstate, topo, frames, generator=gen, static=tstatic),
                                    card, profile_dir, "train_rmp"),
        }

    # bit for bit: the same step twice, RMP and the balancer path, with no
    # deterministic-algorithms setting
    small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
    normal = torch.randn(small["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 2))
    sframes = trainer.frames(small)
    hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, sframes, tstatic),
                        generator=torch.Generator().manual_seed(seed + 4))
    _bit_for_bit("rmp", _train_twice(trainer, state, topo, sframes, tstatic, normal.cuda(), hyper.cuda()))
    bconfig = balancer_config()
    bmodel = get_model(bconfig)
    btrainer = Trainer(bmodel, bconfig)
    btopo = bmodel.topology_from_trajectory(traj, device=btrainer.device)
    bstatic = btrainer.expansion.prepare(bmodel, frame0, btopo)
    bstate = bmodel.init_state(torch.Generator().manual_seed(seed + 1))
    _bit_for_bit("balancer", _train_twice(btrainer, bstate, btopo, btrainer.frames(small), bstatic,
                                          normal.cuda(), None))

    # the card against the CPU, B = 2, same state, noise and static; then
    # the card again with each planted K1 fault, which must break a limit
    vs_cpu, faults = rmp_vs_cpu(traj, small, normal, hyper, seed, predictor.device)
    timings["vs_cpu"], timings["vs_cpu_faults"] = vs_cpu, faults
    for key, errs in vs_cpu.items():
        tol = RMP_TOL[key.split()[0]]
        if any(errs[k] > tol[k] for k in tol):
            raise AssertionError(f"rmp {key} vs CPU outside {tol}: {errs}")
    for key, errs in faults.items():
        tol = RMP_TOL[key.split()[0]]
        if not any(errs[k] > tol[k] for k in tol):
            raise AssertionError(f"rmp {key}: a planted fault passed the card-vs-CPU check: {errs}")
        if key.endswith(RMP_TIER_CONTROL[key.split()[0]]) and not errs["tier_grad"] > tol["tier_grad"]:
            raise AssertionError(f"rmp {key}: the tier fault passed the cluster tier's limit: {errs}")

    timings["unfused_paths"] = rmp_unfused_paths(card, seed, config, traj, state, normal, hyper)
    launches = {k: serve[k] + train[k] for k in serve}
    return launches, timings, kernels


# The same file's RMP on the paths without a kernel, at full depth: the
# rollout cut to RMP_UNFUSED_ROLLOUT_STEPS steps and one train step each, for
# the script's time limit; the card against the CPU in float32 (RMP_TOL).
RMP_UNFUSED_PATHS = ("gather", "xla")
RMP_UNFUSED_ROLLOUT_STEPS = 5


def rmp_unfused_paths(card, seed, config, traj, state, normal, hyper):
    """configs/flag_full_scale.yaml as shipped (RMP) with ``agg_vjp: gather``
    and ``xla`` through ``Predictor`` (one_step B = 21, a short rollout) and
    a single-device ``Trainer`` step at full depth (15 hierarchical blocks,
    bf16), no kernel launched (counted); then the train step's loss and
    gradients and one_step's accelerations on the card against the CPU in
    float32 at B = 2 (RMP_TOL, ``rmp_runs``)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    frame0 = {k: v[0] for k, v in traj.items()}
    small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
    out = {}
    for agg_vjp in RMP_UNFUSED_PATHS:
        cfg = rmp_config(agg_vjp=agg_vjp)
        predictor = Predictor(cfg, state=state)
        model = predictor.model
        blocks = model.gnn_config.message_passing_steps
        if (blocks, model.gnn_config.architecture, model.gnn_config.agg_vjp) != (15, "hyper", agg_vjp):
            raise AssertionError(f"rmp {agg_vjp}: {model.gnn_config}")
        trainer = Trainer(model, cfg)
        topo = model.topology_from_trajectory(traj, device=trainer.device)
        frames = trainer.frames({k: v[:TRAIN_FRAMES] for k, v in traj.items()})
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        pred = predictor.one_step({k: v[:ONE_STEP_FRAMES] for k, v in traj.items()})
        result = predictor.rollout(traj, num_steps=RMP_UNFUSED_ROLLOUT_STEPS)
        tstatic = trainer.expansion.prepare(model, frame0, topo)
        tstate, loss = trainer.train_step(trainer.init_train_state(state=state), topo, frames, generator=gen,
                                          static=tstatic)
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts.values()):
            raise AssertionError(f"rmp {agg_vjp}: kernels launched on a path without one: {counts}")
        if not (np.isfinite(pred).all() and np.isfinite(result["mse"]).all() and np.isfinite(float(loss))):
            raise AssertionError(f"rmp {agg_vjp}: outputs not finite")
        timings = dict(one_step_ms=_host_ms(lambda: predictor.one_step(
            {k: v[:ONE_STEP_FRAMES] for k, v in traj.items()}, static=predictor.expansion.static), 3),
            train_step_ms=_host_ms(lambda: trainer.train_step(tstate, topo, frames, generator=gen,
                                                              static=tstatic), 3))
        # the card against the CPU, float32, B = 2, one state, noise and static
        cfg32 = rmp_config(agg_vjp=agg_vjp, compute_dtype=None)
        cmodel = get_model(cfg32)
        cstate = rmp_state(cfg32, traj, seed + 1)
        ctopo = cmodel.topology_from_trajectory(small, device="cpu")
        static = Trainer(cmodel, cfg32, device="cpu").expansion.prepare(cmodel, frame0, ctopo)
        runs = rmp_runs(cfg32, cstate, small, static, normal, hyper, ("card",))
        (lc, gc, ac), (lg, gg, ag) = runs["cpu"], runs["card"]
        in_tier = lambda n: any(tag in n for tag in RMP_TIER)
        errs = {n: rel_l2(gg[n], g) for n, g in gc.items()}
        vs_cpu = dict(loss=abs(lg - lc) / abs(lc), grad=max(e for n, e in errs.items() if not in_tier(n)),
                      tier_grad=max(e for n, e in errs.items() if in_tier(n)),
                      acceleration=float(np.abs(ag - ac).max() / np.abs(ac).max()))
        out[agg_vjp] = dict(timings, launches=counts, vs_cpu_float32=vs_cpu)
        log(f"rmp {agg_vjp} (no kernel on this path): one_step B={ONE_STEP_FRAMES} {timings['one_step_ms']:.2f} ms "
            f"with a prepared static, train step B={TRAIN_FRAMES} {timings['train_step_ms']:.2f} ms, "
            f"{RMP_UNFUSED_ROLLOUT_STEPS}-step rollout MSE {result['mse'][-1]:.4g}; float32 card vs CPU "
            f"B={CPU_FRAMES}: {vs_cpu} (limits {RMP_TOL['float32']}) [{card}]")
        if any(vs_cpu[k] > RMP_TOL["float32"][k] for k in vs_cpu):
            raise AssertionError(f"rmp {agg_vjp} float32 card vs CPU outside {RMP_TOL['float32']}: {vs_cpu}")
    return out


# cylinder and plate MeshGraphNets as configs/cylinder.yaml and plate.yaml ship
# them (latent 128, 5 blocks, float32, agg_vjp fused, remat, batch 16) on
# synthetic meshes at the published datasets' scale (Pfaff et al., ICLR 2021:
# about 1,885 nodes for cylinder_flow, 1,271 for deforming_plate).
MODEL_MESHES = {"cylinder": (59, 32), "plate": (36, 36)}
MODEL_SIZES = {"cylinder": (1888, 10966), "plate": (1312, 5040)}  # nodes, mesh edges
MODEL_FIELDS = {"cylinder": "velocity", "plate": "world_pos"}
MODEL_CLI = {"cylinder": "cylinder_demo", "plate": "plate_demo"}
MODEL_FRAMES = 16  # the files' batch_size
# The card against the CPU, float32, 5 blocks, same state and noise, B = 2:
# loss rtol 1e-4, each gradient within relative L2 1e-3 (TRAIN_TOL's float32
# limits); one_step's update within 1e-3 of its largest step (and cylinder's
# pressure of its largest value): first set at 1e-4 before any card reading,
# it sits 10x above plate's 9.2e-5 (cylinder 1.4e-5; PERF.md section 6; the
# stamp's 16 nodes carry inputs 30 standard deviations out, and their
# updates' rounding leads).  The state's normalizers sit at their
# accumulation cap, as after 10**6 steps, so the train step standardizes with
# the state's statistics on both sides: on the 36x36 plate every mesh edge
# has one length, the mesh_edge normalizer's |rel_mesh| column has no
# variance, and a batch accumulated in would standardize float32 rounding
# (tests/test_torch_port_plate.py).
MODEL_TOL = {"loss": 1e-4, "grad": 1e-3, "update": 1e-3}


def model_config(name):
    """configs/<name>.yaml as shipped, its shape checked."""
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml(name)
    m, t = config["params"]["model"], config["params"]["task"]
    got = (m["message_passing_steps"], m.get("latent_size", 128), m.get("compute_dtype"), m["agg_vjp"],
           m.get("fused_bwd", "remat"), t["batch_size"])
    if got != (5, 128, None, "fused", "remat", MODEL_FRAMES):
        raise AssertionError(f"configs/{name}.yaml is not MGN-5 latent 128 float32 fused remat B=16: {got}")
    return config


def model_trajectory(name, seed, num_steps):
    from hyper_graph_nets_tpu_torch.data import synthetic
    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets

    nx, ny = MODEL_MESHES[name]
    gen = synthetic.cylinder_trajectory if name == "cylinder" else synthetic.plate_trajectory
    return add_targets(gen(num_steps=num_steps, nx=nx, ny=ny, seed=seed), MODEL_FIELDS[name], False)


def model_state(model, traj, seed):
    """Seeded weights (CPU) whose normalizers have seen the trajectory in
    training mode."""
    import torch

    state = model.init_state(torch.Generator().manual_seed(seed))
    topo = model.topology_from_trajectory(traj, device="cpu")
    frames = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    with torch.no_grad():
        _, _, state = model.make_graph(state, topo, frames, True)
        _, state = model.get_target(state, frames, True)
    return state


def capped(state):
    """``state`` with every normalizer at its accumulation cap."""
    import dataclasses

    import torch

    return state.replace(normalizers={
        k: dataclasses.replace(v, num_accumulations=torch.full_like(v.num_accumulations, v.max_accumulations))
        for k, v in state.normalizers.items()
    })


def _update_errors(name, got, want, base):
    """one_step's largest error over its largest step (cylinder: and the
    pressure's over its largest value)."""
    import numpy as np

    if name == "cylinder":
        (v, p), (wv, wp) = got, want
        return dict(update=float(np.abs(v - wv).max() / np.abs(wv - base).max()),
                    pressure=float(np.abs(p - wp).max() / np.abs(wp).max()))
    return dict(update=float(np.abs(got - want).max() / np.abs(want - base).max()))


def phase_model(card, peaks, seed, name, profile_dir=None):
    """Cylinder or plate as its config ships, end to end on the card: serving
    (one_step B=16, a 50-step rollout; 5 K1 per forward, none for plate's
    world edges), K1/K2 in float32 at the mesh's shapes against their plain
    versions, training (5 K1 + 5 K2 a step, loss falling over 30 steps, two
    steps from one state bit for bit), the card against the CPU, plate's
    world edges and their fixed-order sums with no host sync (the CLI on the
    bf16 demo config is in ``phase_cli``)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.core.segment_ops import aggregate
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    config = model_config(name)
    model = get_model(config)
    blocks, field = model.gnn_config.message_passing_steps, MODEL_FIELDS[name]
    traj = model_trajectory(name, seed, ROLLOUT_STEPS + 3)
    N, E = MODEL_SIZES[name]
    topo_cpu = model.topology_from_trajectory(traj, device="cpu")
    if (topo_cpu.num_nodes, int(topo_cpu.senders.shape[0])) != (N, E) or topo_cpu.plan is None:
        raise AssertionError(f"{name}: {topo_cpu.num_nodes} nodes, {topo_cpu.senders.shape[0]} edges, plan "
                             f"{topo_cpu.plan is not None}; want {N}, {E} and a K1/K2 plan")
    state = model_state(model, traj, seed)
    B = MODEL_FRAMES
    batch = {k: v[:B] for k, v in traj.items()}
    extra = f", world-edge capacity {topo_cpu.world_cap} (auto)" if name == "plate" else ""
    log(f"{name}: MGN-{blocks} latent 128 float32 fused remat, N={N}, E={E} mesh edges{extra}; one_step B={B}, "
        f"rollout {ROLLOUT_STEPS}")

    # serving, the main path: counts set to 0 just before, read just after
    predictor = Predictor(config, state=state)
    reset_counts()
    pred = predictor.one_step(batch)
    one = read_counts()
    result = predictor.rollout(traj, num_steps=ROLLOUT_STEPS)
    serve = read_counts()
    truncated = model.pop_eval_metrics().get("world_edge_truncated", 0)
    want = dict.fromkeys(serve, 0)
    want["K1"] = blocks * (1 + ROLLOUT_STEPS)
    if one["K1"] != blocks or serve != want:
        raise AssertionError(f"{name} serving launches {one} in one_step, {serve} in all; want {want}")
    key = "pred_pos" if name == "plate" else "pred_velocity"
    shapes = [a.shape for a in (pred if name == "cylinder" else (pred,))]
    if shapes != ([(B, N, 2), (B, N, 1)] if name == "cylinder" else [(B, N, 3)]) or not all(
        np.isfinite(a).all() for a in (pred if name == "cylinder" else (pred,))
    ):
        raise AssertionError(f"{name} one_step output {shapes} not finite/shaped")
    if result[key].shape[:2] != (ROLLOUT_STEPS, N) or not np.isfinite(result["mse"]).all():
        raise AssertionError(f"{name} rollout output not finite/shaped")
    log(f"{name} serving launches: {one['K1']} K1 per one_step, {serve} in all; rollout MSE "
        f"{result['mse'][0]:.4g} -> {result['mse'][-1]:.4g}"
        + (f"; radius-query hits past the capacity in the rollout: {truncated}" if name == "plate" else ""))

    # one_step on the card against the CPU, same state
    cpu_pred = Predictor(config, state=state, device="cpu").one_step(batch)
    errs = _update_errors(name, pred, cpu_pred, batch[field])
    log(f"{name} one_step card vs CPU: {errs} (limit {MODEL_TOL['update']})")
    if max(errs.values()) > MODEL_TOL["update"]:
        raise AssertionError(f"{name} one_step card vs CPU outside {MODEL_TOL['update']}: {errs}")

    topo = predictor._topology(traj)
    if name == "plate":
        # world edges and their fixed-order sums built on the card, no host sync
        frames = predictor._frames(batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                graph, aux, _ = model.make_graph(predictor.state, topo, frames, False)
                es = graph.edge_sets["world_edges"]
                agg = aggregate(es.features, es.receivers, N, "pna", es.mask, sums=es.sums.receivers)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        hits = es.mask.sum(dim=-1)
        log(f"plate world edges of {B} frames, built and summed with host syncs an error: "
            f"{int(hits.min())}-{int(hits.max())} a frame of {es.num_edges} slots, "
            f"{int(aux['world_truncated'].sum())} past the capacity; aggregate {tuple(agg.shape)}")

    # timings of serving (host clock around synchronized work)
    timings = dict(one_step_ms=_host_ms(lambda: predictor.one_step(batch), 5), world_edge_truncated=truncated,
                   one_step_vs_cpu=errs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.rollout(traj, num_steps=ROLLOUT_STEPS)
    timings["rollout_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / ROLLOUT_STEPS
    timings["one_step_edges_per_s"] = B * E / (timings["one_step_ms"] / 1e3)
    log(f"{name} one_step B={B}: {timings['one_step_ms']:.2f} ms ({timings['one_step_edges_per_s']:.4g} mesh "
        f"edges/s); rollout {timings['rollout_ms_per_step']:.2f} ms/step [{card}]")

    # training, the main path
    trainer = Trainer(model, config)
    ttopo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames(batch)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tstate = trainer.init_train_state(state=state)
    reset_counts()
    tstate, loss, metrics = trainer.train_step(tstate, ttopo, frames, generator=gen, with_metrics=True)
    torch.cuda.synchronize()
    train = read_counts()
    want = dict.fromkeys(train, 0)
    want["K1"] = want["K2"] = blocks
    if train != want:
        raise AssertionError(f"{name} train step launches {train}, want {want}")
    losses, step_s = [float(loss)], []
    for _ in range(LOSS_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstate, loss = trainer.train_step(tstate, ttopo, frames, generator=gen)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name} loss did not fall over {LOSS_STEPS} steps: {losses}")
    ms = 1e3 * float(np.median(step_s[WARMUP_STEPS : WARMUP_STEPS + TIMED_STEPS]))
    timings.update(train_step_ms=ms, train_edges_per_s=B * E / (ms / 1e3), first_loss=losses[0],
                   last_loss=losses[-1], train_counters={k: float(v) for k, v in metrics.items()})
    log(f"{name} train step B={B}: {train}; {ms:.2f} ms (median of {TIMED_STEPS} after {WARMUP_STEPS} warm-up), "
        f"{timings['train_edges_per_s']:.4g} mesh edges/s; loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
        f"{LOSS_STEPS} steps; counters {timings['train_counters']} [{card}]")
    if profile_dir:
        timings["profile"] = {
            "one_step": device_profile(lambda: predictor.one_step(batch), card, profile_dir, f"one_step_{name}"),
            "rollout_5_steps": device_profile(lambda: predictor.rollout(traj, num_steps=5), card, profile_dir,
                                              f"rollout_{name}"),
            "train": device_profile(lambda: trainer.train_step(tstate, ttopo, frames, generator=gen), card,
                                    profile_dir, f"train_{name}"),
        }

    # the same step twice from one state and noise, bit for bit
    normal = torch.randn(batch[field].shape, generator=torch.Generator().manual_seed(seed + 2))
    _bit_for_bit(name, _train_twice(trainer, state, ttopo, frames, None, normal.cuda(), None))

    # the card against the CPU, B = 2, the same capped state and noise
    small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
    cstate, runs = capped(state), {}
    for device in ("cpu", "cuda"):
        tr = Trainer(model, config, device=device)
        ts = tr.init_train_state(state=cstate)
        l, _ = tr.loss_and_grads(ts, model.topology_from_trajectory(small, device=device), tr.frames(small),
                                 normal=normal[:CPU_FRAMES].to(device))
        runs[device] = (float(l), {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()})
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    worst = sorted(((rel_l2(gg[n], gc[n]), n) for n in gc), reverse=True)
    vs_cpu = dict(loss=abs(lg - lc) / abs(lc), grad=worst[0][0])
    timings["train_vs_cpu"] = vs_cpu
    log(f"{name} train step card vs CPU, B={CPU_FRAMES}: loss rel {vs_cpu['loss']:.3g}; worst gradients (relative "
        f"L2) {', '.join(f'{e:.3g} {n}' for e, n in worst[:3])} (limits {MODEL_TOL})")
    if vs_cpu["loss"] > MODEL_TOL["loss"] or vs_cpu["grad"] > MODEL_TOL["grad"]:
        raise AssertionError(f"{name} train step card vs CPU outside {MODEL_TOL}: {vs_cpu}")

    launches = {k: serve[k] + train[k] for k in serve}
    return launches, timings


def phase_model_kernels(card, peaks, seed):
    """K1 and K2 in float32 at cylinder's and plate's shapes (B = 16, the
    synthetic meshes of ``phase_model``, each topology's own plan) against
    their plain versions; plate's 16 stamp rows have no mesh edge."""
    import numpy as np

    from hyper_graph_nets_tpu_torch.core.graph import NodeType
    from hyper_graph_nets_tpu_torch.models.get_model import get_model

    out = {}
    for name in ("cylinder", "plate"):
        model = get_model(model_config(name))
        traj = model_trajectory(name, seed, 4)
        topo = model.topology_from_trajectory(traj, device="cuda")
        snd, rcv = topo.senders.cpu().numpy(), topo.receivers.cpu().numpy()
        N = topo.num_nodes
        empty = np.bincount(rcv, minlength=N) == 0
        obstacles = int((traj["node_type"][0][:, 0] == NodeType.OBSTACLE).sum())  # plate's stamp
        if int(empty.sum()) != obstacles:
            raise AssertionError(f"{name}: {int(empty.sum())} rows without mesh edges, want the {obstacles} "
                                 "obstacle nodes")
        out[name] = planned_kernels(card, peaks, topo.plan, snd, rcv, N, MODEL_FRAMES, "float32", seed + 7,
                                    f"{name} mesh")
    return out


# Meshes of different sizes in one dataset (cross-trajectory bucketing, the
# real cylinder_flow, deforming_plate and flag_simple property): written in
# the real schema (meta.json with -1 node dimensions) from the synthetic
# generators, then the task loop of configs/cylinder.yaml and plate.yaml as
# shipped over them.  Cylinder: training meshes of 1,824, 1,888 and 1,900
# nodes (the span of real cylinder_flow meshes; Pfaff et al., ICLR 2021:
# about 1,885 on average), validation 1,872, test 1,848; plate: 1,312 and
# 1,269 nodes for training (the 36 x 36 plate of phase_model and a 35 x 36
# one with a 9-node stamp), 1,276 and 1,234 for validation and test.
# Trajectories cut to BUCKET_STEPS frames (19 after the target window, 18
# trained and evaluated: 400 and 300 in the real data), the n-step windows
# to BUCKET_N_STEP steps (60 in the files), for the script's time limit.
BUCKET_MESHES = {
    "cylinder": {"train": ((48, 38), (59, 32), (50, 38)), "valid": ((52, 36),), "test": ((56, 33),)},
    "plate": {"train": ((36, 36), (35, 36)), "valid": ((36, 35),), "test": ((35, 35),)},
}
BUCKET_DATASETS = {"cylinder": "cylinder_flow", "plate": "deforming_plate"}
BUCKET_STEPS = 20
BUCKET_TIMESTEPS = 18
BUCKET_N_STEP = 4
# one-step scalars of a padded trajectory against its unpadded run, both on
# the card (masked means: the same up to summation order, float32), and the
# padded rollout and n-step losses against the unpadded ones times n / C
BUCKET_TOL = 1e-5


def bucket_config(name):
    """configs/<name>.yaml as shipped (checked by ``model_config``) with the
    task settings of the bucketed dataset above."""
    config = model_config(name)
    task = config["params"]["task"]
    if task["dataset"] != BUCKET_DATASETS[name]:
        raise AssertionError(f"configs/{name}.yaml reads {task['dataset']}")
    task.update(
        epochs=1, trajectories=len(BUCKET_MESHES[name]["train"]), n_timesteps=BUCKET_TIMESTEPS,
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": BUCKET_N_STEP},
    )
    return config


def write_bucket_dataset(root, name, seed):
    """The meshes of ``BUCKET_MESHES[name]`` as TFRecords in the real schema
    under ``root``; returns each split's node counts."""
    from hyper_graph_nets_tpu_torch.data import synthetic, tfrecord
    from hyper_graph_nets_tpu_torch.data.loader import get_directories

    dataset = BUCKET_DATASETS[name]
    in_dir, _ = get_directories(dataset, root)
    os.makedirs(in_dir)
    sizes = {}
    for i, (split, meshes) in enumerate(BUCKET_MESHES[name].items()):
        trajs = [synthetic.GENERATORS[dataset](num_steps=BUCKET_STEPS, nx=nx, ny=ny, seed=seed + 100 * i + j)
                 for j, (nx, ny) in enumerate(meshes)]
        tfrecord.write_trajectories(os.path.join(in_dir, f"{split}.tfrecord"), trajs)
        sizes[split] = [int(t["node_type"].shape[1]) for t in trajs]
    meta = synthetic.make_meta(dataset, trajs[0])
    for spec in meta["features"].values():
        spec["shape"][1] = -1  # the node (or cell) count varies between trajectories
    with open(os.path.join(in_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return sizes


def bucket_launches(blocks, B, T, n_step, train_trajectories):
    """The task's K1 and K2 launches over ``run_iterations`` and
    ``get_scalars``: a fit batch is ``blocks`` K1 + K2; each evaluation
    split runs the one-step evaluator (a forward a batch), a T-step rollout
    and one chunk of ``T - n_step`` n-step windows (n_step + 1 forwards)."""
    batches = -(-T // B)
    fit = blocks * batches * train_trajectories
    evaluation = blocks * (batches + T + n_step + 1)
    return {"K1": fit + 2 * evaluation, "K2": fit}


def phase_bucketed(card, peaks, seed, profile_dir=None):
    """Cylinder and plate as configs/cylinder.yaml and plate.yaml ship them
    (float32, B = 16, 5 blocks, latent 128, fused remat; plate's world edges
    at ``max_world_edges: auto``) through the task loop on a dataset whose
    meshes differ in size (``BUCKET_MESHES``): ``get_task`` finds the sizes
    vary and pads every trajectory to one capacity, ``run_iterations`` and
    ``get_scalars`` run with the counts set to 0 just before and read just
    after (K1 and K2 on padded topologies only), K1 and K2 on the smallest
    training mesh's padded topology against their plain versions, the
    padded rows of a rollout 0, the one-step scalars of a padded test
    trajectory those of its unpadded run on the card, its rollout and
    n-step losses those times n / C, and the epoch's seconds and busy
    share."""
    import tempfile

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data import bucketing
    from hyper_graph_nets_tpu_torch.data.loader import get_data
    from hyper_graph_nets_tpu_torch.models.base import Topology
    from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan
    from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
    from hyper_graph_nets_tpu_torch.training.task import get_task

    launches, timings, rows = {}, {}, {}
    for name in ("cylinder", "plate"):
        config = bucket_config(name)
        task_cfg = config["params"]["task"]
        with tempfile.TemporaryDirectory(prefix=f"hgn_bucket_{name}_") as root:
            sizes = write_bucket_dataset(root, name, seed)
            splits = {s: list(get_data(config, s, data_dir=root)) for s in BUCKET_MESHES[name]}
            want_cap = bucketing.trajectory_capacity([t for ts in splits.values() for t in ts])
            t0 = time.perf_counter()
            task = get_task(config, data_dir=root)
            setup_s = time.perf_counter() - t0
            sim = task.simulator
            if sim.capacity != want_cap or not isinstance(sim._plan_dims, dict):
                raise AssertionError(f"bucketed {name}: capacity {sim.capacity} (want {want_cap}), band decision "
                                     f"{sim._plan_dims}")
            C = want_cap[0]
            blocks = sim.model.gnn_config.message_passing_steps
            log(f"bucketed {name}: meshes of {sizes} nodes padded to {C} nodes and {want_cap[1]} edges; "
                f"MGN-{blocks} latent {sim.model.latent_size} float32 fused remat, B={task_cfg['batch_size']}, "
                f"{BUCKET_TIMESTEPS} frames a trajectory (cut), n-step windows of {BUCKET_N_STEP} (cut)")

            # the main path: the epoch and the test split's scalars
            reset_counts()
            t0 = time.perf_counter()
            task.run_iterations()
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            scalars = task.get_scalars()
            counts = read_counts()
            want = dict.fromkeys(counts, 0)
            want.update(bucket_launches(blocks, task_cfg["batch_size"], BUCKET_TIMESTEPS, BUCKET_N_STEP,
                                        len(splits["train"])))
            if counts != want:
                raise AssertionError(f"bucketed {name} launches {counts}, want {want}")
            if not all(np.isfinite(v) for v in scalars.values()) or (
                    name == "plate") != ("test_world_edge_truncated" in scalars):
                raise AssertionError(f"bucketed {name} scalars: {scalars}")
            topos = [t for t in sim._topo_cache.values() if isinstance(t, Topology)]
            if len(topos) != sum(len(ts) for ts in splits.values()) or not all(
                    t.num_nodes == C and isinstance(t.plan, SegmentPlan) and t.mask is not None for t in topos):
                raise AssertionError(f"bucketed {name}: {len(topos)} topologies, not all at {C} rows with a "
                                     "K1/K2 plan and a mask")
            if name == "plate":
                extras = sim._topo_extras
                bad = [(t.world_cap, tuple(t.aux["obstacle_idx"].shape)) for t in topos
                       if t.world_cap < extras["world_floor"] or t.aux["obstacle_idx"].shape[0] != extras["obstacle_cap"]]
                if bad:
                    raise AssertionError(f"bucketed plate: topologies off the bucket's dims {extras}: {bad}")
            log(f"bucketed {name} launches over run_iterations + get_scalars: {counts}; epoch {epoch_s:.2f} s, "
                f"setup (scan, capacity.json, band decision) {setup_s:.2f} s; scalars {scalars} [{card}]")

            # K1 and K2 on the smallest training mesh's padded topology
            small = min(splits["train"], key=lambda t: t["node_type"].shape[1])
            ptraj = sim._prepare(small)
            ptopo = sim._topology(ptraj)
            mask = ptopo.mask.cpu().numpy()
            n = int(small["node_type"].shape[1])
            rows[name] = planned_kernels(card, peaks, ptopo.plan, ptopo.senders.cpu().numpy(),
                                         ptopo.receivers.cpu().numpy(), C, task_cfg["batch_size"], "float32",
                                         seed + 11, f"bucketed {name}, {n} of {C} rows, "
                                         f"{int(mask.sum())} of {mask.size} edges", mask=mask)

            # the test trajectory padded against its own unpadded run on the card
            test = splits["test"][0]
            n = int(test["node_type"].shape[1])
            plain = MeshSimulator(config, out_dir=os.path.join(root, "plain"))
            padded = {}
            for tag, s in (("padded", sim), ("unpadded", plain)):
                padded[tag] = dict(
                    one_step=s.one_step_evaluator(task.tstate, [test], logging=False),
                    rollout=s.rollout_evaluator(task.tstate, [test], num_steps=BUCKET_TIMESTEPS, logging=False,
                                                save=False),
                    n_step=s.n_step_evaluator(task.tstate, [test], n_step=BUCKET_N_STEP,
                                              num_timesteps=BUCKET_TIMESTEPS, logging=False),
                )
            p, u = padded["padded"], padded["unpadded"]
            key = "pred_pos" if name == "plate" else "pred_velocity"
            pred = p["rollout"]["rollouts"][0][key]
            if pred.shape[1] != C or np.abs(pred[:, n:]).max() != 0:
                raise AssertionError(f"bucketed {name}: the padded rows of the rollout are not 0")
            errs = {
                "validation_loss": abs(p["one_step"]["validation_loss"] / u["one_step"]["validation_loss"] - 1),
                "position_error": abs(p["one_step"]["position_error"] / u["one_step"]["position_error"] - 1),
                "rollout_loss n/C": abs(p["rollout"]["rollout_loss"] / (u["rollout"]["rollout_loss"] * n / C) - 1),
                "n_step_loss n/C": abs(p["n_step"]["n_step_loss"] / (u["n_step"]["n_step_loss"] * n / C) - 1),
                "rollout positions": float(np.abs(pred[:, :n] - u["rollout"]["rollouts"][0][key]).max()
                                           / np.abs(u["rollout"]["rollouts"][0][key]).max()),
            }
            log(f"bucketed {name} test mesh ({n} of {C} rows) padded against unpadded on the card: rollout loss "
                f"{p['rollout']['rollout_loss']:.6g} vs {u['rollout']['rollout_loss']:.6g} (n/C {n / C:.4f}); "
                f"relative differences {errs} (limit {BUCKET_TOL})")
            if max(errs.values()) > BUCKET_TOL:
                raise AssertionError(f"bucketed {name}: padded against unpadded outside {BUCKET_TOL}: {errs}")

            timings[name] = dict(epoch_s=epoch_s, setup_s=setup_s, capacity=list(want_cap), sizes=sizes,
                                 scalars=scalars, vs_unpadded=errs, launches=counts)
            if name == "cylinder":
                timings[name]["profile"] = device_profile(task.run_iterations, card,
                                                          profile_dir or os.path.join(root, "trace"),
                                                          "bucketed_epoch_cylinder")
            launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    return launches, timings, rows


# HyperGraphNets on plate as configs/plateCluster.yaml ships it (spectral
# clustering into 16 clusters, connector hyper, 5 hierarchical blocks, latent
# 128, float32, agg_vjp fused remat, batch 16) on phase_model's 36 x 36 plate
# and stamp: the mesh set over N + 16 = 1,328 rows, plate's world edges
# unfused, and with rmp.fused_tiers also the three cluster-tier sets through
# K1/K2 over their valid prefixes.
HGN_CONFIG = "plateCluster"
HGN_CLI_CONFIG = "plateCluster_demo"
HGN_CLUSTERS = 16
HGN_TIER_PLANS = {"intra_cluster_to_cluster": "up_plan", "intra_cluster_to_mesh": "down_plan",
                  "inter_cluster": "inter_plan"}
# The card against the CPU (B = 2, the same capped state, noise and static;
# the CPU with the tiers unfused, the card with fused_tiers off and on): the
# limits of RMP_TOL["float32"], the one_step update (the next positions less
# the current) held as RMP's accelerations, but the cluster tier's at 5e-3:
# on an NVIDIA H100 80GB HBM3 at 700 W the sound card read 4.4e-4 on the
# cluster tier (both ways; the mesh tier 1.2e-4, the update 5.0e-5, the loss
# 0), and the dropped intra_cluster_to_mesh edge 9.2e-3, under RMP's 1e-2,
# so that limit would have no control here (PERF.md section 6).
# Planted controls, each of which must break a limit: K1's lost receivers
# (TASK_FAULTS; one float32 unit in e2, e2_ulp, sits inside these limits,
# as on RMP), the dropped intra_cluster_to_mesh edge (RMP_TIER_FAULT_EDGE,
# the cluster tier's own limit) and, with fused_tiers, the first receiver's
# aggregate lost in the tier sets' K1 launches (_fault_first_receiver).
HGN_TOL = {"loss": RMP_TOL["float32"]["loss"], "grad": RMP_TOL["float32"]["grad"], "tier_grad": 5e-3,
           "update": RMP_TOL["float32"]["acceleration"]}
HGN_TRAIN_STEPS = (3, 5)  # warm-up and timed train steps


def _fault_first_receiver(e2, agg, *rest, receivers):
    """The aggregate row of the set's first receiver left at zero (a tier
    set's work group not written: one hyper row of the up set)."""
    agg = agg.clone()
    agg[:, int(receivers[0])] = 0
    return (e2, agg, *rest)


def hgn_config(fused_tiers=False):
    """configs/plateCluster.yaml as shipped, checked, with ``fused_tiers``."""
    config = model_config(HGN_CONFIG)
    rmp = config["params"]["model"]["rmp"]
    want = dict(clustering="spectral", connector="hyper", num_clusters=HGN_CLUSTERS, hyper_node_features=True)
    if {k: rmp.get(k) for k in want} != want or rmp.get("fused_tiers") or rmp.get("inter_cluster_world"):
        raise AssertionError(f"plateCluster's rmp settings changed: {rmp}")
    rmp["fused_tiers"] = fused_tiers
    return config


def _tier_plans(static):
    return {name: getattr(static, field) for name, field in HGN_TIER_PLANS.items()}


def phase_hgn_kernels(card, peaks, seed):
    """K1 and K2 in float32 at B = 16 on HGN plate's sets against their plain
    versions: the mesh set over the 1,328 rows, and the three cluster-tier
    sets over their valid-prefix plans (the up set's 16 hyper receivers of
    about 81 edges each, longer than a tile, and its masked tail of the 16
    stamp nodes; down, one edge a mesh row; inter, at most 16 x 15 edges)."""
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

    config = hgn_config(fused_tiers=True)
    model = get_model(config)
    traj = model_trajectory("plate", seed, 4)
    topo = model.topology_from_trajectory(traj, device="cuda")
    (static,) = build_expansion(model, config).prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    N, rows = topo.num_nodes, topo.num_nodes + HGN_CLUSTERS
    host = lambda t: t.cpu().numpy()
    out = {"mesh": planned_kernels(card, peaks, static.mesh_plan, host(topo.senders), host(topo.receivers), rows,
                                   MODEL_FRAMES, "float32", seed + 8, "HGN plate mesh")}
    for name, plan in _tier_plans(static).items():
        if plan is None:
            raise AssertionError(f"HGN plate: no K1/K2 plan for {name} with fused_tiers")
        prefix = HGN_TIER_PLANS[name][: -len("_plan")]
        snd, rcv, mask = (host(getattr(static, f"{prefix}_{f}")) for f in ("senders", "receivers", "mask"))
        valid = int(mask.sum())
        longest = int((plan.row_ptr[1:] - plan.row_ptr[:-1]).max())
        log(f"HGN plate {name}: {len(snd)} edges, {valid} valid, longest segment {longest}, "
            f"{plan.num_groups} work groups over {rows} rows")
        out[name] = planned_kernels(card, peaks, plan, snd, rcv, rows, MODEL_FRAMES, "float32", seed + 9,
                                    f"HGN plate {name}", mask=mask)
    return out


def phase_hgn(card, peaks, seed, profile_dir=None):
    """HGN plate as configs/plateCluster.yaml ships it, with fused_tiers off
    (as shipped) and on: serving (one_step B = 16, a 50-step rollout), two
    train steps from one state bit for bit, train-step times, the launches
    counted in advance (5 K1 a forward and 5 K2 a train step on the mesh set;
    with fused_tiers 20 of each: mesh, up, down, inter), the card against the
    CPU with the planted controls (the CLI on plateCluster_demo is in
    ``phase_cli``)."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    traj = model_trajectory("plate", seed, ROLLOUT_STEPS + 3)
    frame0 = {k: v[0] for k, v in traj.items()}
    base_config = hgn_config()
    state = rmp_state(base_config, traj, seed)
    B = MODEL_FRAMES
    batch = {k: v[:B] for k, v in traj.items()}
    small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
    normal = torch.randn(batch["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 2))
    launches, timings = {}, {}
    for fused_tiers in (False, True):
        tag = "fused_tiers" if fused_tiers else "as shipped"
        config = hgn_config(fused_tiers)
        predictor = Predictor(config, state=state)
        model = predictor.model
        blocks = model.gnn_config.message_passing_steps
        N = predictor._topology(traj).num_nodes
        E = int(predictor._topology(traj).senders.shape[0])
        if (N, E) != MODEL_SIZES["plate"] or model.gnn_config.architecture != "hyper":
            raise AssertionError(f"HGN plate: {N} nodes, {E} edges, {model.gnn_config.architecture}")
        # the launches counted in advance: the mesh set, and with fused_tiers
        # the three tier sets (the JAX package's rule fuses all three on this
        # plate: the up set's widest sender window is 1,408 rows)
        fused_sets = 1 + (len(HGN_TIER_PLANS) if fused_tiers else 0)
        log(f"HGN plate ({tag}): {N} nodes + {HGN_CLUSTERS} clusters, {E} mesh edges, {blocks} hierarchical "
            f"blocks, latent 128 float32; one_step B={B}, rollout {ROLLOUT_STEPS}; {fused_sets} fused set(s)")

        # serving, the main path: counts set to 0 just before, read just after
        reset_counts()
        pred = predictor.one_step(batch)
        one = read_counts()
        result = predictor.rollout(traj, num_steps=ROLLOUT_STEPS)
        serve = read_counts()
        (rstat,) = predictor.expansion.static
        plans = {n: p is not None for n, p in _tier_plans(rstat).items()}
        if plans != dict.fromkeys(HGN_TIER_PLANS, fused_tiers):
            raise AssertionError(f"HGN plate ({tag}): tier plans {plans}")
        want = dict.fromkeys(serve, 0)
        want["K1"] = blocks * fused_sets * (1 + ROLLOUT_STEPS)
        if one["K1"] != blocks * fused_sets or serve != want:
            raise AssertionError(f"HGN plate ({tag}) serving launches {one} in one_step, {serve} in all; "
                                 f"want {want}")
        if pred.shape != (B, N, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"HGN plate one_step output {pred.shape} not finite/shaped")
        if result["pred_pos"].shape[:2] != (ROLLOUT_STEPS, N) or not np.isfinite(result["mse"]).all():
            raise AssertionError("HGN plate rollout output not finite/shaped")
        log(f"HGN plate ({tag}) serving launches: {one['K1']} K1 per one_step, {serve} in all; cluster sizes "
            f"{sorted(int(x) for x in rstat.sizes.tolist())}; rollout MSE {result['mse'][0]:.4g} -> "
            f"{result['mse'][-1]:.4g}")
        static = predictor.expansion.static
        t = dict(
            one_step_ms=_host_ms(lambda: predictor.one_step(batch), 5),
            one_step_static_ms=_host_ms(lambda: predictor.one_step(batch, static=static), 5),
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.rollout(traj, num_steps=ROLLOUT_STEPS)
        t["rollout_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / ROLLOUT_STEPS
        log(f"HGN plate ({tag}) one_step B={B}: {t['one_step_ms']:.2f} ms with its prepare, "
            f"{t['one_step_static_ms']:.2f} ms with a prepared static; rollout {t['rollout_ms_per_step']:.2f} "
            f"ms/step [{card}]")

        # training, the main path: two steps from one state bit for bit, then
        # the launches of one step and its time
        trainer = Trainer(model, config)
        ttopo = model.topology_from_trajectory(traj, device=trainer.device)
        frames = trainer.frames(batch)
        tstatic = trainer.expansion.prepare(model, frame0, ttopo)
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, tstatic),
                            generator=torch.Generator().manual_seed(seed + 4))
        reset_counts()
        _bit_for_bit(f"HGN plate, {tag}", _train_twice(trainer, state, ttopo, frames, tstatic, normal.cuda(),
                                                       hyper.cuda()))
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        tstate = trainer.init_train_state(state=state)
        reset_counts()
        tstate, loss = trainer.train_step(tstate, ttopo, frames, generator=gen, static=tstatic)
        torch.cuda.synchronize()
        train = read_counts()
        want = dict.fromkeys(train, 0)
        want["K1"] = want["K2"] = blocks * fused_sets
        if train != want or not np.isfinite(float(loss)):
            raise AssertionError(f"HGN plate ({tag}) train step launches {train}, want {want}; loss {float(loss)}")
        step_s = []
        warm, timed = HGN_TRAIN_STEPS
        for _ in range(warm + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tstate, loss = trainer.train_step(tstate, ttopo, frames, generator=gen, static=tstatic)
            float(loss)
            step_s.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(step_s[warm:]))
        t.update(train_step_ms=ms, train_edges_per_s=B * E / (ms / 1e3))
        log(f"HGN plate ({tag}) train step B={B}: {train}; {ms:.2f} ms (median of {timed} after {warm} "
            f"warm-up), {t['train_edges_per_s']:.4g} mesh edges/s [{card}]")
        if profile_dir:
            name = "hgn_tiers" if fused_tiers else "hgn"
            t["profile"] = {
                "one_step": device_profile(lambda: predictor.one_step(batch, static=static), card, profile_dir,
                                           f"one_step_{name}"),
                "rollout_5_steps": device_profile(lambda: predictor.rollout(traj, num_steps=5, static=static),
                                                  card, profile_dir, f"rollout_{name}"),
                "train": device_profile(lambda: trainer.train_step(tstate, ttopo, frames, generator=gen,
                                                                   static=tstatic),
                                        card, profile_dir, f"train_{name}"),
            }
        timings[tag] = t
        launches = {k: launches.get(k, 0) + serve[k] + train[k] for k in serve}

    # the card against the CPU at B = 2, the same capped state, noise and
    # static; then the card again with each planted control
    vs_cpu, faults = hgn_vs_cpu(traj, small, capped(state), normal[:CPU_FRAMES], seed)
    timings["vs_cpu"], timings["vs_cpu_faults"] = vs_cpu, faults
    for key, errs in vs_cpu.items():
        if any(errs[k] > HGN_TOL[k] for k in HGN_TOL):
            raise AssertionError(f"HGN plate {key} vs CPU outside {HGN_TOL}: {errs}")
    for key, errs in faults.items():
        if not any(errs[k] > HGN_TOL[k] for k in HGN_TOL):
            raise AssertionError(f"HGN plate {key}: a planted fault passed the card-vs-CPU check: {errs}")
        if key.endswith("tier_drop") and not errs["tier_grad"] > HGN_TOL["tier_grad"]:
            raise AssertionError(f"HGN plate {key}: the dropped tier edge passed the cluster tier's limit: {errs}")

    return launches, timings


def hgn_vs_cpu(traj, small, cstate, normal, seed):
    """HGN plate's train step (loss, mesh-tier and cluster-tier gradients) and
    one_step update on the card, with fused_tiers off and on, against the
    CPU with the tiers unfused (B = CPU_FRAMES, one static prepared on the
    CPU, the same noise), and the card again with each planted control.
    Returns ``(sound, faulted)``: ``{"<tiers> <where>": {limit: reading}}``."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    frame0 = {k: v[0] for k, v in traj.items()}
    in_tier = lambda n: any(tag in n for tag in RMP_TIER)
    k1 = fb.fused_edge_block_fwd
    E = MODEL_SIZES["plate"][1]

    def run(config, static, device, plant=None):
        model = get_model(config)
        tr = Trainer(model, config, device=device)
        topo = model.topology_from_trajectory(small, device=device)
        st = tuple(s.to(device) for s in static)
        frames = tr.frames(small)
        hyper = torch.randn(tr.expansion.hyper_noise_shape(model, frames, st),
                            generator=torch.Generator().manual_seed(seed + 4))
        if plant is not None:
            fb.fused_edge_block_fwd = plant
        try:
            ts = tr.init_train_state(state=cstate)
            loss, _ = tr.loss_and_grads(ts, topo, frames, normal=normal.to(device), static=st,
                                        hyper_normal=hyper.to(device))
            grads = {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()}
            pred = Predictor(config, state=cstate, device=device).one_step(small, static=st)
        finally:
            fb.fused_edge_block_fwd = k1
        return float(loss), grads, pred - small["world_pos"]

    def statics(config):
        model = get_model(config)
        topo = model.topology_from_trajectory(small, device="cpu")
        static = Trainer(model, config, device="cpu").expansion.prepare(model, frame0, topo)
        return static

    lost = lambda *a, **kw: TASK_FAULTS["lost_receivers"](*k1(*a, **kw))
    tier_k1 = lambda *a, **kw: (_fault_first_receiver(*k1(*a, **kw), receivers=a[5]) if a[0].shape[1] != E
                                else k1(*a, **kw))
    cpu_static = statics(hgn_config())
    lc, gc, uc = run(hgn_config(), cpu_static, "cpu")
    vs_cpu, faults = {}, {}
    for fused_tiers in (False, True):
        config = hgn_config(fused_tiers)
        static = statics(config)
        if not np.array_equal(static[0].labels.numpy(), cpu_static[0].labels.numpy()):
            raise AssertionError("HGN plate: the two prepares clustered differently")
        runs = {"card": (static, None), "card lost_receivers": (static, lost),
                "card tier_drop": ((_drop_down_edges(static[0], [RMP_TIER_FAULT_EDGE]),) + static[1:], None)}
        if fused_tiers:
            runs["card tier_k1"] = (static, tier_k1)
        tag = "fused_tiers" if fused_tiers else "as shipped"
        for where, (st, plant) in runs.items():
            l, g, u = run(config, st, "cuda", plant)
            errs = sorted(((rel_l2(g[n], gc[n]), n) for n in gc), reverse=True)
            rest = [e for e in errs if not in_tier(e[1])]
            tier = [e for e in errs if in_tier(e[1])]
            out = dict(loss=abs(l - lc) / abs(lc), grad=rest[0][0], tier_grad=tier[0][0],
                       update=float(np.abs(u - uc).max() / np.abs(uc).max()))
            top = lambda es: ", ".join(f"{e:.3g} {n}" for e, n in es[:3])
            log(f"HGN plate {tag} {where} vs CPU, B={CPU_FRAMES}: loss rel {out['loss']:.3g}; one_step update "
                f"{out['update']:.3g}; worst gradients (relative L2) {top(rest)}; of the cluster tier {top(tier)} "
                f"(limits {HGN_TOL})")
            (vs_cpu if where == "card" else faults)[f"{tag} {where}"] = out
    return vs_cpu, faults


# -- the CLI on every family, all runs started together -------------------------

# (config, runs): a config's runs go one after another in one data directory,
# the second resuming from the first's checkpoint; the configs run side by
# side, each in a process of its own (each is host-bound).  flag_full_scale
# (RMP) runs once: the resume is checked on flag_fused_demo.
CLI_RUNS = ((CLI_CONFIG, 2), (RMP_CLI_CONFIG, 1), (MODEL_CLI["cylinder"], 1), (MODEL_CLI["plate"], 1),
            (HGN_CLI_CONFIG, 1))


def phase_cli(card):
    """``python -m hyper_graph_nets_tpu_torch.main <config>`` for each of
    ``CLI_RUNS`` on the card: every run exits 0 and prints its scalars,
    flag_fused_demo's second run resumes from epoch 1, flag_full_scale's
    cluster images are listed.  Times are of runs that share the card and
    the host's cores."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    # the CLI processes share the card with this one: hand back what its
    # caching allocator holds unused (each rank group's streams keep pools
    # of their own, which no later phase's default-stream allocation reuses)
    reserved = torch.cuda.memory_reserved() / 2**30
    torch.cuda.empty_cache()
    log(f"CLI: this process held {reserved:.2f} GiB of the card, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        "after handing back its cache")

    def runs(root, name, n):
        out = []
        for _ in range(n):
            cli = [sys.executable, "-m", "hyper_graph_nets_tpu_torch.main", name, "--data-dir", root]
            t0 = time.perf_counter()
            out.append((subprocess.run(cli, cwd=HERE, capture_output=True, text=True, timeout=600),
                        time.perf_counter() - t0))
        return out

    timings = {}
    with tempfile.TemporaryDirectory(prefix="hgn_cli_") as root:
        dirs = {name: os.path.join(root, name) for name, _ in CLI_RUNS}
        with ThreadPoolExecutor(len(CLI_RUNS)) as pool:
            done = {name: pool.submit(runs, dirs[name], name, n) for name, n in CLI_RUNS}
            results = {name: f.result() for name, f in done.items()}
        for name, outs in results.items():
            for run, (out, seconds) in enumerate(outs):
                if out.returncode != 0:
                    raise AssertionError(f"CLI {name} run {run} exited {out.returncode}:\n{out.stdout[-4000:]}\n"
                                         f"{out.stderr[-4000:]}")
                log(f"CLI {name} run {run}: exit 0 in {seconds:.1f} s; "
                    + ", ".join(out.stdout.strip().splitlines()[-4:]))
            timings[name] = [seconds for _, seconds in outs]
        with open(os.path.join(dirs[CLI_CONFIG], "flag_simple", "output", "run.metrics.jsonl")) as f:
            if '"resumed_from_epoch": 1.0' not in f.read():
                raise AssertionError(f"the second CLI run of {CLI_CONFIG} did not resume from epoch 1")
        out_dir = os.path.join(dirs[RMP_CLI_CONFIG], "flag_simple", "output")
        images = [n for n in os.listdir(out_dir) if n.startswith("cluster_epoch")]
        log(f"CLI {RMP_CLI_CONFIG}: cluster images {images or 'none (no matplotlib)'} [{card}]")
    return timings


# -- int8 (W8A8) serving: model.inference_quant int8 on every model family ------

# The int8 paths served (config, agg_vjp, B, rollout steps): flag_full_scale
# with RMP off as shipped (fused: every set unfused under int8, no K1) and
# with sorted (K4f), flag_full_scale as shipped (RMP, 16 clusters, bf16) and
# plateCluster as shipped (float32, world edges, RMP).  The RMP paths roll
# out 20 steps: each step re-expands through the unfused tiers on the host.
INT8_PATHS = (
    ("flat fused", ONE_STEP_FRAMES, ROLLOUT_STEPS),
    ("flat sorted", ONE_STEP_FRAMES, ROLLOUT_STEPS),
    ("rmp", ONE_STEP_FRAMES, 20),
    ("hgn plate", MODEL_FRAMES, 20),
)
# Card against CPU (the port's int8 on both, 2 frames).  Whole-model
# closeness cannot hold int8 to much: a one-ulp change of the input
# positions moves the CPU's own int8 update by as much as int8 moves it from
# float (relative L2 1.6% on plateCluster), since every activation is
# requantized per row in every layer and a rounding on the other side of a
# code boundary is carried on (PERF.md, int8 findings).  So the check is layer by
# layer: the card's int8 state equals the CPU's (codes, scales, biases),
# and every dense layer of the card's one_step, fed the card's own input,
# equals the CPU's dense layer (with the CPU state's weights) on that input
# bit for bit; one weight code of the card's state flipped
# (``_flip_one_code``) must break it.  End to end, the update's relative L2
# against the CPU's must stay within INT8_TOL["l2"] times int8's own error
# on the card (int8 against float, same state and frames): two independent
# draws of the quantization noise read up to sqrt(2) times it.  Read on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.40, 0.46, 0.86 and 0.95 times
# it on the four paths; every 64th row of each int8 product lost
# (``lost_product_rows``), the planted fault this limit must catch, 4.4-8.5
# times; the flipped code 0.77-1.40 times, under the limit: one code moves
# the update less than int8 itself does, so only the layer check sees it.
INT8_TOL = {"l2": 2.0}


def int8_config(path):
    if path == "flat fused":
        return main_config()
    if path == "flat sorted":
        return main_config(agg_vjp="sorted")
    if path == "rmp":
        return rmp_config()
    return hgn_config()


def int8_errors(got, want, start):
    """An update against another: the largest error over the largest move
    (``move``) and the relative L2 error of the update (``l2``), the move
    taken from ``start`` (2 x - prev on flag, x on plate)."""
    import numpy as np

    err = np.abs(got.astype(np.float64) - want)
    move = np.abs(want.astype(np.float64) - start)
    return {"move": float(err.max() / move.max()), "l2": float(np.linalg.norm(err) / np.linalg.norm(move))}


@contextlib.contextmanager
def dense_int8_replaced(fn):
    """Within the block every int8 dense layer of the port calls
    ``fn(x, w_q, wscale)``; yields the ``dense_int8`` it replaced, which
    ``fn`` may call."""
    from hyper_graph_nets_tpu_torch.nn import quant

    kept = quant.dense_int8
    quant.dense_int8 = fn
    try:
        yield kept
    finally:
        quant.dense_int8 = kept


def int8_layers(predictor, cpu, frames):
    """The card's one_step on ``frames`` layer by layer against the CPU:
    ``(dense layers, of them not bit for bit with the CPU's dense layer on
    the card's input, state tensors that differ from the CPU's)``.  The
    CPU's one_step runs first and records its layers' weights in call order;
    the card's then feeds each layer's input to the CPU layer of its rank."""
    import torch

    from hyper_graph_nets_tpu_torch.nn import quant

    dense, weights, mismatched = quant.dense_int8, [], []

    def recording(x, w_q, wscale):
        weights.append((w_q, wscale))
        return dense(x, w_q, wscale)

    def checking(x, w_q, wscale):
        y = dense(x, w_q, wscale)
        i = len(mismatched)
        mismatched.append(i >= len(weights) or not torch.equal(y.cpu(), dense(x.cpu(), *weights[i])))
        return y

    for device_run, fn in ((cpu, recording), (predictor, checking)):
        with dense_int8_replaced(fn):
            device_run.one_step(frames)
    card, host = dict(predictor.state.params.named_parameters()), dict(cpu.state.params.named_parameters())
    states = sum(not torch.equal(t.cpu(), host[n]) for n, t in card.items()) + (card.keys() != host.keys())
    return len(mismatched), sum(mismatched) + abs(len(mismatched) - len(weights)), states


def lost_product_rows(dense):
    """``dense`` with every 64th row of each int8 product's output left at
    zero (a work group not written): the planted fault the end-to-end limit
    must catch."""
    def lost(x, w_q, wscale):
        y = dense(x, w_q, wscale).clone()
        y.reshape(-1, y.shape[-1])[::64] = 0
        return y
    return lost


def int8_ok(errs):
    return errs["l2"] <= INT8_TOL["l2"] * errs["quant_l2"]


# kernel groups of an int8 forward's trace, first match wins: the int8
# products (torch._int_mm's CUTLASS / cuBLAS s8 kernels), the per-row
# quantize passes, the aggregations, the port's K1, float products
INT8_KERNEL_GROUPS = (
    ("int8 product", ("gemm_s8", "i8i32")),
    ("quantize (abs, round, clamp)", ("AbsFunctor", "round_kernel", "clamp")),
    ("aggregation (gathers, scatters, K4f)", ("scatter", "gather", "index", "pna_fwd_kernel")),
    ("K1", ("fused_block_fwd",)),
    ("float products", ("gemm", "nvjet", "xmma")),
)


def kernel_groups(profile):
    """``device_profile``'s kernels summed by ``INT8_KERNEL_GROUPS``:
    {group: (ms, launches)}; the rest under "other"."""
    out = {}
    for k in profile["kernels"]:
        group = next((g for g, keys in INT8_KERNEL_GROUPS if any(key in k["name"] for key in keys)), "other")
        ms, n = out.get(group, (0.0, 0))
        out[group] = (ms + k["ms"], n + k["count"])
    return out


def _flip_one_code(predictor, frames):
    """``predictor``'s int8 state with one weight code negated: in the
    middle block's node model's last layer, the largest code that reads the
    hidden unit most active on ``frames`` (so the fault reaches the output
    whatever the ReLUs do).  The planted fault of the card-vs-CPU layer
    check, and of the task's int8 evaluators."""
    import copy

    import torch

    from hyper_graph_nets_tpu_torch.nn.quant import dense_int8

    mid = len(predictor.state.params.blocks) // 2
    node_model = predictor.state.params.blocks[mid].node_model
    seen = []
    hook = node_model.register_forward_hook(lambda m, args, out: seen.append(args[0]))
    try:
        predictor.one_step(frames)
    finally:
        hook.remove()
    h = seen[0]
    with torch.no_grad():
        for i in range(node_model.num_layers - 1):
            h = torch.relu(dense_int8(h, node_model.weights[i], node_model.wscales[i]) + node_model.biases[i])
        j = int(h.float().reshape(-1, h.shape[-1]).mean(0).argmax())
        net = copy.deepcopy(predictor.state.params)
        w = net.blocks[mid].node_model.weights[-1]
        c = int(w[:, j].abs().argmax())
        w[c, j] = -w[c, j]
    return predictor.state.replace(params=net)


def phase_int8(card, seed, profile_dir=None):
    """Int8 (W8A8) serving through ``Predictor(quantize="int8")``: the dense
    layer on the card bit for bit with the CPU at every shape the main paths
    give it (real activations, and the same rows in bf16); for each of
    ``INT8_PATHS`` one_step and a rollout with the launches counted (no K1,
    15 K4f a forward under sorted, one int8 product a dense layer), the
    card against the CPU at 2 frames layer by layer and end to end with a
    planted control (``INT8_TOL``), the int8 update against the float one
    on the same state (context), and int8 and float times in the same
    call."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.nn import quant
    from hyper_graph_nets_tpu_torch.serving import Predictor

    flag = add_targets(flag_trajectory(num_steps=ROLLOUT_STEPS + 3, nx=40, ny=40, seed=seed), "world_pos",
                       history=True)
    plate = model_trajectory("plate", seed, ROLLOUT_STEPS + 3)
    launches, timings, dense = {}, {}, {}
    for path, B, steps in INT8_PATHS:
        config = int8_config(path)
        traj = plate if path == "hgn plate" else flag
        model = get_model(config)
        state = rmp_state(config, traj, seed) if path in ("rmp", "hgn plate") else model_state(model, traj, seed)
        predictor = Predictor(config, state=state, quantize="int8")
        floats = Predictor(config, state=state)
        cfg = predictor.model.gnn_config
        batch = {k: v[:B] for k, v in traj.items()}
        small = {k: v[:CPU_FRAMES] for k, v in traj.items()}
        start = lambda b: 2 * b["world_pos"] - b["prev|world_pos"] if "prev|world_pos" in b else b["world_pos"]
        log(f"int8 ({path}): {config['params']['model'].get('compute_dtype') or 'float32'}, "
            f"{cfg.message_passing_steps} blocks, {cfg.architecture}, agg_vjp {cfg.agg_vjp}; one_step B={B}, "
            f"rollout {steps}")

        # every dense input the card sees in one_step and the rollout's first
        # step, first of each (rows, in, out), kept for the dense check
        record = {}

        def recording(x, w_q, wscale, kept=quant.dense_int8):
            key = (int(np.prod(x.shape[:-1])), x.shape[-1], w_q.shape[0])
            if key not in record:
                record[key] = (x.detach().clone(), w_q, wscale)
            return kept(x, w_q, wscale)

        # the main path: counts set to 0 just before, read just after
        with dense_int8_replaced(recording):
            reset_counts()
            quant.int8_matmul.calls = 0
            pred = predictor.one_step(batch)
            one = dict(read_counts(), int8=quant.int8_matmul.calls)
            predictor.rollout(traj, num_steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = predictor.rollout(traj, num_steps=steps)
        torch.cuda.synchronize()
        rollout_ms = 1e3 * (time.perf_counter() - t0) / steps
        serve = read_counts()
        per_forward = 15 if path == "flat sorted" else 0
        want = dict.fromkeys(serve, 0)
        want["K4f"] = per_forward * (2 + steps)
        if one["K1"] or one["K4f"] != per_forward or serve != want:
            raise AssertionError(f"int8 ({path}) launches {one} in one_step, {serve} in all; want {want}")
        if pred.shape != batch["world_pos"].shape or not np.isfinite(pred).all() \
                or not np.isfinite(result["mse"]).all():
            raise AssertionError(f"int8 ({path}) output not finite/shaped")
        dense.update({(path,) + k: v for k, v in record.items() if (path,) + k not in dense})

        # the card against the CPU at 2 frames (each prepares its own
        # expansion on the same first frame), then the planted controls
        cpu = Predictor(config, state=state, device="cpu", quantize="int8")
        layers, bad, states = int8_layers(predictor, cpu, small)
        want_small, floats_small = cpu.one_step(small), floats.one_step(small)
        got_small = predictor.one_step(small)
        quant_l2 = int8_errors(got_small, floats_small, start(small))["l2"]
        errs = dict(int8_errors(got_small, want_small, start(small)), quant_l2=quant_l2)
        kept = predictor.state
        predictor.state = _flip_one_code(predictor, small)
        flipped = int8_layers(predictor, cpu, small)
        flipped_errs = dict(int8_errors(predictor.one_step(small), want_small, start(small)), quant_l2=quant_l2)
        predictor.state = kept
        with dense_int8_replaced(lost_product_rows(quant.dense_int8)):
            lost_errs = dict(int8_errors(predictor.one_step(small), want_small, start(small)), quant_l2=quant_l2)
        quant_err = int8_errors(pred, floats.one_step(batch), start(batch))
        log(f"int8 ({path}) launches: {one} in one_step, {serve} in all; {layers} dense layers a forward, each "
            f"bit for bit with the CPU's on the card's input (the flipped code: {flipped[1]} layer(s) and "
            f"{flipped[2]} state tensor(s) differ); card vs CPU update (B={CPU_FRAMES}): {errs} (limit l2 "
            f"{INT8_TOL['l2']} x quant_l2); with the flipped code {flipped_errs}; with lost product rows "
            f"{lost_errs}; int8 vs float at B={B} (context): {quant_err}")
        if one["int8"] != layers or bad or states:
            raise AssertionError(f"int8 ({path}): {one['int8']} int8 products a forward at B={B}, {layers} at "
                                 f"B={CPU_FRAMES}; {bad} of them not bit for bit with the CPU's, {states} "
                                 f"state tensors not the CPU's")
        if not flipped[1]:
            raise AssertionError(f"int8 ({path}): the flipped code passed the layer check: {flipped}")
        if not int8_ok(errs):
            raise AssertionError(f"int8 ({path}) card vs CPU outside {INT8_TOL}: {errs}")
        if int8_ok(lost_errs):
            raise AssertionError(f"int8 ({path}): lost product rows passed {INT8_TOL}: {lost_errs}")

        # int8 and float times, same state, same call
        t = dict(int8_one_step_ms=_host_ms(lambda: predictor.one_step(batch), 5),
                 float_one_step_ms=_host_ms(lambda: floats.one_step(batch), 5),
                 int8_rollout_ms_per_step=rollout_ms, vs_cpu=errs, int8_vs_float=quant_err,
                 flipped_code_layers=flipped[1], flipped_code_vs_cpu=flipped_errs, lost_rows_vs_cpu=lost_errs,
                 int8_products_per_forward=one["int8"])
        floats.rollout(traj, num_steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float_result = floats.rollout(traj, num_steps=steps)
        torch.cuda.synchronize()
        t["float_rollout_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
        # context: the JAX package's tests hold the int8 rollout's MSE to 10x the float one's
        t["rollout_mse"] = {"int8": float(np.mean(result["mse"])), "float": float(np.mean(float_result["mse"]))}
        log(f"int8 ({path}) one_step B={B}: {t['int8_one_step_ms']:.2f} ms (float {t['float_one_step_ms']:.2f}); "
            f"rollout {rollout_ms:.2f} ms/step (float {t['float_rollout_ms_per_step']:.2f}); rollout MSE "
            f"{t['rollout_mse']['int8']:.4g} (float {t['rollout_mse']['float']:.4g}) [{card}]")
        if profile_dir:
            tag = path.replace(" ", "_")
            t["profile"] = {
                "int8_one_step": device_profile(lambda: predictor.one_step(batch), card, profile_dir,
                                                f"one_step_int8_{tag}", top=12),
                "float_one_step": device_profile(lambda: floats.one_step(batch), card, profile_dir,
                                                 f"one_step_float_{tag}", top=12),
            }
            for which, prof in t["profile"].items():
                groups = kernel_groups(prof)
                prof["groups"] = groups
                log(f"{which} ({path}) kernel groups: " + "; ".join(
                    f"{g} {ms:.3f} ms x{n}" for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]))
                    + f" [{card}]")
        timings[path] = t
        launches = {k: launches.get(k, 0) + serve[k] for k in serve}

    # the dense layer: card against CPU bit for bit at every recorded shape,
    # on the recorded activations and on the same rows in bf16
    padded = 0
    for (path, M, K, N), (x, w_q, ws) in sorted(dense.items()):
        for xx in (x, x.to(torch.bfloat16)):
            got = quant.dense_int8(xx, w_q, ws).cpu()
            want = quant.dense_int8(xx.cpu(), w_q.cpu(), ws.cpu())
            if not torch.equal(got, want):
                raise AssertionError(f"dense_int8 card vs CPU differs at {path} M={M} K={K} N={N} {xx.dtype}")
        padded += bool(M < quant.MIN_ROWS or K % quant.WIDTH_MULTIPLE or N % quant.WIDTH_MULTIPLE)
    shapes = sorted({k[1:] for k in dense})
    log(f"int8 dense: card equals CPU bit for bit at {len(shapes)} shapes (float32 and bf16 inputs), {padded} "
        f"of them padded for _int_mm: {shapes}")
    timings["dense_shapes"] = [list(s) for s in shapes]
    return launches, timings


# -- clustering with a variable cluster count ------------------------------------------

# The frames the two HDBSCAN reclusterings take on the 40x40 flag: frame 0
# (flat: K = 10, Kp 16 at seed 0) and frame 5 (K = 40, Kp 64 at seed 0).
CLUSTER_FRAMES = (0, 5)
CLUSTER_ROLLOUT_STEPS = 10
CLUSTER_TRAIN_STEPS = 3
CLUSTER_BLOCKS = 5  # k-means and the mixture: cut from 15 for the script's time limit
CLUSTER_K = 16  # k-means' and the mixture's clusters, as the file ships num_clusters
# The bf16 cluster tier's limit here, card against CPU (RMP_TOL's other
# limits hold as they are): 0.2.  HDBSCAN's tier reads 0.150 at frame 0 (K
# 10, 1,232 of 1,600 nodes noise, so 368 members feed the hyper rows) and
# 0.098 at frame 5, k-means 0.078, the mixture 0.083, past RMP_TOL's 0.12
# (set by spectral clustering's 0.073 and its cluster fault's 0.182).  The
# bisection run, the card fed the CPU's expand outputs, reads as much
# (0.156, 0.104, 0.078, 0.093), so the spread arises in the bf16 network,
# and it is bf16 rounding's own size: each bf16 side reads 0.079-0.144
# from the float32 CPU run.  The planted tier fault (``tier_cluster_drop``)
# reads 0.34 on the tier at HDBSCAN's frame 0 but 0.107-0.176 elsewhere,
# inside the sound runs' range, so no tier limit separates it; it breaks the
# accelerations' limit in every case (0.030-0.048 against 0.02; sound
# 0.0015-0.0034), and the check requires a planted fault to break one
# limit.  Readings on an NVIDIA H100 80GB HBM3 at 700 W, the same on every
# run of this code (the train step is bit for bit; PERF.md section 6).
CLUSTER_TIER_TOL = 0.2


def cluster_config(name, blocks=None):
    """configs/flag_full_scale.yaml with ``rmp.clustering: name`` and every
    other RMP key (the ``hdbscan:`` block included) as the file ships them;
    ``blocks`` cuts the depth."""
    config = rmp_config()
    rmp = config["params"]["model"]["rmp"]
    hb = rmp["hdbscan"]
    if (hb["min_cluster_size"], hb["max_cluster_size"], hb["min_samples"], rmp["num_clusters"]) != (20, 50, 1,
                                                                                                   CLUSTER_K):
        raise AssertionError(f"flag_full_scale's rmp block changed: {rmp}")
    rmp["clustering"] = name
    if blocks is not None:
        config["params"]["model"]["message_passing_steps"] = blocks
    return config


def run_errors(run, ref):
    """``{loss, grad, tier_grad, acceleration, worst}`` of one run of
    ``rmp_runs`` against another, as ``rmp_vs_cpu`` reads them."""
    import numpy as np

    (lg, gg, ag), (lc, gc, ac) = run, ref
    in_tier = lambda n: any(tag in n for tag in RMP_TIER)
    errs = sorted(((rel_l2(gg[n], gc[n]), n) for n in gc), reverse=True)
    return dict(loss=abs(lg - lc) / abs(lc), grad=max(e for e, n in errs if not in_tier(n)),
                tier_grad=max(e for e, n in errs if in_tier(n)),
                acceleration=float(np.abs(ag - ac).max() / np.abs(ac).max()),
                worst=[f"{e:.3g} {n}" for e, n in errs[:3]])


def phase_cluster(card, peaks, seed):
    """Remote message passing with the clusterings that copy scikit-learn
    (``rmp.sk_numpy``) and the JAX package's HDBSCAN (``rmp.hdbscan_tree``)
    on configs/flag_full_scale.yaml (latent 128, bf16, fused remat): with
    HDBSCAN and the file's ``hdbscan:`` block at its 15 blocks, two
    reclusterings (CLUSTER_FRAMES) whose padded cluster counts Kp differ,
    each followed by ``Predictor.one_step`` on 21 frames, a 10-step
    rollout and 3 train steps at B = 21 (15 K1 per forward, 15 K1 + 15 K2 a
    step, counted around each call), the mesh set's plan over N + Kp rows
    after each, K1 and K2 over those rows against their plain versions, and
    the card against the CPU at B = 2 from the same state, noise and static
    (``RMP_TOL``; the bf16 cluster tier ``CLUSTER_TIER_TOL``), again with
    the CPU's expand outputs fed in, and with a planted tier fault that must
    break a limit; then k-means and the Gaussian
    mixture (K = 16) cut to CLUSTER_BLOCKS blocks: one_step and one train
    step each, held the same way.  K, Kp and the host seconds of each
    recluster are logged."""
    import copy

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.serving import Predictor
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    traj = add_targets(flag_trajectory(num_steps=max(CLUSTER_FRAMES) + ONE_STEP_FRAMES + 3, nx=40, ny=40, seed=seed),
                       "world_pos", history=True)
    window = lambda f, n: {k: v[f : f + n] for k, v in traj.items()}
    N = 1600
    launches, timings, rows = dict.fromkeys(read_counts(), 0), {}, {}
    gen = torch.Generator().manual_seed(seed + 21)
    readings = {}  # "<case> <dtype> <where>": errors against the CPU

    def counted(tag, fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        expect = dict.fromkeys(counts, 0)
        expect.update(want)
        if counts != expect:
            raise AssertionError(f"cluster {tag}: launches {counts}, want {expect}")
        for k in launches:
            launches[k] += counts[k]
        return out

    def held(tag, config, state, frame, static):
        """The card against the CPU at B = CPU_FRAMES in float32 and in bf16
        (the path's type), and in bf16 the bisection and tier-fault runs of
        ``rmp_runs`` and each bf16 side against the float32 CPU run (the
        rounding's own size, logged); every reading goes to ``readings``."""
        small = window(frame, CPU_FRAMES)
        shape = (CPU_FRAMES, static[-1].num_clusters, small["world_pos"].shape[-1] + small["mesh_pos"].shape[-1])
        normal, hyper = torch.randn(small["world_pos"].shape, generator=gen), torch.randn(shape, generator=gen)
        out = {}
        for dtype_name in ("float32", "bfloat16"):
            cfg = copy.deepcopy(config)
            cfg["params"]["model"]["compute_dtype"] = None if dtype_name == "float32" else dtype_name
            wheres = ("card",) if dtype_name == "float32" else ("card", "card cpu_expand", "card tier_cluster_drop")
            runs = rmp_runs(cfg, state, small, static, normal, hyper, wheres)
            pairs = [(where, "cpu") for where in wheres]
            if dtype_name == "bfloat16":
                pairs += [("cpu", "float32 cpu"), ("card", "float32 cpu")]
                runs["float32 cpu"] = float32_cpu
            else:
                float32_cpu = runs["cpu"]
            for where, ref in pairs:
                errs = run_errors(runs[where], runs[ref])
                log(f"cluster {tag} {dtype_name} {where} vs {ref}, B={CPU_FRAMES}: loss rel {errs['loss']:.3g}, "
                    f"gradients {errs['grad']:.3g}, cluster tier {errs['tier_grad']:.3g}, accelerations "
                    f"{errs['acceleration']:.3g} (worst {errs['worst']})")
                key = f"{dtype_name} {where}" if ref == "cpu" else f"{dtype_name} {where} vs float32 cpu"
                out[key] = readings[f"{tag} {key}"] = errs
        return out

    def run(name, blocks, frames, train_steps, rollout_steps):
        config = cluster_config(name, blocks)
        model = get_model(config)
        cfg = model.gnn_config
        if (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp, cfg.compute_dtype) != (
                L_MAIN, blocks, "fused", "bfloat16"):
            raise AssertionError(f"{name}: not latent 128, {blocks} blocks, fused, bf16: {cfg}")
        state = rmp_state(config, traj, seed + 1)
        predictor = Predictor(config, state=state)
        trainer = Trainer(predictor.model, config)
        exp = predictor.expansion
        rmp = exp.members[-1]
        out = {}
        for f in frames:
            sub = window(f, ONE_STEP_FRAMES)
            topo = predictor._topology(sub)
            t0 = time.perf_counter()
            exp.reset(0, ONE_STEP_FRAMES)
            static = exp.prepare(predictor.model, {k: v[0] for k, v in sub.items()}, topo)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            K, Kp = rmp._last_clustering.num_clusters, static[-1].num_clusters
            plan = static[-1].mesh_plan
            if plan is None or plan.num_nodes != N + Kp:
                raise AssertionError(f"{name} frame {f}: the mesh plan covers "
                                     f"{None if plan is None else plan.num_nodes} rows, want {N + Kp}")
            noise = int((rmp._last_clustering.labels < 0).sum())
            log(f"cluster {name} frame {f}: K = {K}, Kp = {Kp}, {noise} noise nodes; recluster (prepare) "
                f"{host_s:.3f} s on the host")
            tag = f"{name} frame {f}"
            pred = counted(f"{tag} one_step", lambda: predictor.one_step(sub, static=static), {"K1": blocks})
            if not np.isfinite(pred).all() or pred.shape != sub["world_pos"].shape:
                raise AssertionError(f"{tag}: one_step {pred.shape}, finite {np.isfinite(pred).all()}")
            if rollout_steps:
                roll = counted(f"{tag} rollout", lambda: predictor.rollout(sub, num_steps=rollout_steps,
                                                                           static=static),
                               {"K1": blocks * rollout_steps})
                if not np.isfinite(roll["pred_pos"]).all():
                    raise AssertionError(f"{tag}: the rollout is not finite")
            tstate = trainer.init_train_state(state=state)
            frames_b = trainer.frames(sub)
            losses = []
            step_ms = []
            for _ in range(train_steps):
                t0 = time.perf_counter()
                tstate, loss = counted(f"{tag} train step", lambda: trainer.train_step(
                    tstate, topo, frames_b, generator=torch.Generator("cuda").manual_seed(seed), static=static),
                    {"K1": blocks, "K2": blocks})
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(loss))
            if not np.isfinite(losses).all():
                raise AssertionError(f"{tag}: train losses {losses}")
            log(f"cluster {tag}: one_step, {rollout_steps}-step rollout and {train_steps} train steps at "
                f"B={ONE_STEP_FRAMES} (losses {', '.join(f'{x:.5f}' for x in losses)}; host ms a step "
                f"{', '.join(f'{x:.1f}' for x in step_ms)}) [{card}]")
            errs = held(tag, config, state, f, static)
            out[f] = dict(K=K, Kp=Kp, noise_nodes=noise, recluster_host_s=host_s, train_losses=losses,
                          train_step_host_ms=step_ms, vs_cpu=errs, static=static, topo=topo)
        return out

    hdb = run("hdbscan", 15, CLUSTER_FRAMES, CLUSTER_TRAIN_STEPS, CLUSTER_ROLLOUT_STEPS)
    kps = [hdb[f]["Kp"] for f in CLUSTER_FRAMES]
    if len(set(kps)) == 1:
        log(f"cluster hdbscan: the trajectory gave one Kp ({kps[0]}) at frames {CLUSTER_FRAMES}; no change of Kp "
            "between the reclusterings was driven")
    snd, rcv = (hdb[CLUSTER_FRAMES[0]]["topo"].senders.cpu().numpy(),
                hdb[CLUSTER_FRAMES[0]]["topo"].receivers.cpu().numpy())
    for f in CLUSTER_FRAMES:
        Kp = hdb[f]["Kp"]
        if f"rows={N + Kp}" in rows:
            continue
        rows[f"rows={N + Kp}"] = planned_kernels(card, peaks, hdb[f]["static"][-1].mesh_plan, snd, rcv, N + Kp,
                                                 TRAIN_FRAMES, "bfloat16", seed + 31 + f, f"HDBSCAN Kp={Kp}")
    for f in CLUSTER_FRAMES:
        hdb[f].pop("static")
        hdb[f].pop("topo")
    timings["hdbscan"] = hdb
    for name in ("kmeans", "gmm"):
        res = run(name, CLUSTER_BLOCKS, CLUSTER_FRAMES[:1], 1, 0)
        for r in res.values():
            r.pop("static")
            r.pop("topo")
        timings[name] = res

    # the limits, after every reading is logged: sound runs within RMP_TOL
    # (in bf16 the cluster tier within CLUSTER_TIER_TOL), the planted tier
    # fault past one of them
    failed = []
    for key, errs in readings.items():
        if key.endswith("vs float32 cpu"):
            continue
        tol = dict(RMP_TOL[key.split()[3]])
        if key.split()[3] == "bfloat16":
            tol["tier_grad"] = CLUSTER_TIER_TOL
        if key.endswith("tier_cluster_drop"):
            if not any(errs[k] > tol[k] for k in tol):
                failed.append(f"{key}: the planted tier fault passed the card-vs-CPU check {tol}: {errs}")
        elif any(errs[k] > tol[k] for k in tol):
            failed.append(f"{key}: card vs CPU {errs} past {tol}")
    if failed:
        raise AssertionError("cluster: " + "; ".join(failed))
    timings["readings"] = readings
    return launches, timings, rows


# -- the pod: processes on one card, and over NCCL on cards of their own --------------

POD_PROCESSES = 2
POD_GRAPH = 2  # graph_per_host: over two ranks a process, the pod is 2 x 2; over one, 1 x 2 (graph across)
POD_FRAMES = 8  # the global batch
POD_TIMEOUT_S = 240  # each worker's limit
POD_TIMED = 2  # timed pod steps of the 1 x 2 fused pod, each beside an in-process step (in turns)
# Each parameter's gradient, summed over the pod before Adam, against the
# in-process step's: relative L2.  Adam's first update is about lr x the
# gradient's sign, so the updates (read 3.29e-6, NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 6) would not see gradients off by a common factor
# (one process's part lost); the gradients are held as well.  The same
# partials summed in another order: float32 rounding (the CPU test reads
# 6.9e-8 and holds 1e-6), so 1e-5.  The 2 x 2 pod only: the pods whose
# graph row spans processes are held bit for bit.
POD_GRAD_TOL = 1e-5
# the pods over NCCL, a process on cards of its own: (processes, cards a
# process, graph_per_host), their shapes, and the cards they need
POD_CARDS_LAYOUTS = (((2, 2, 4), (1, 4)), ((4, 1, 2), (2, 2)))
POD_CARDS_SMALL = ((2, 1, 2), (1, 2))  # on two or three cards
POD_RING_REPS = 20  # K6 and K7 calls timed per rank in the 1 x 4 pod, each beside an in-process call (in turns)
POD_RING_PROBE_REPS = 20  # K6 calls across the two processes on one card (phase_pod)
POD_CARDS_TIMEOUT_S = 480  # phase_pod_cards' workers, each layout's five runs
POD_HALO_TIMED = 3  # halo forwards timed on the host clock per path and pod
POD_HOST_GROUP = None  # a pod worker's gloo group: its barriers wait on the host, never in a kernel on a card
POD_GROUPS = weakref.WeakSet()  # a pod worker's groups, whose error words watch_error_words reads


def pod_case(seed):
    """What the pod and the in-process step start from: the config
    (flag_full_scale, RMP off, noise 0.003, gamma 0.9, lr 1e-4), a seeded
    state whose normalizers have seen the trajectory, the trajectory, the
    POD_FRAMES frames and a global noise draw (CPU tensors)."""
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model

    config = main_config(noise=0.003, gamma=0.9, learning_rate=1e-4)
    traj = add_targets(flag_trajectory(num_steps=POD_FRAMES + 2, nx=40, ny=40, seed=seed), "world_pos",
                       history=True)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(seed))
    every = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    with torch.no_grad():
        topo = model.topology_from_trajectory(traj, device="cpu")
        _, _, state = model.make_graph(state, topo, every, True)
        _, state = model.get_target(state, every, True)
    frames = {k: v[:POD_FRAMES].numpy() for k, v in every.items()}
    normal = torch.randn(frames["world_pos"].shape, generator=torch.Generator().manual_seed(seed + 41))
    return dict(config=config, traj=traj, frames=frames, normal=normal,
                params={n: p.detach().clone() for n, p in state.params.named_parameters()},
                normalizers=state.normalizers)


def _pod_model_state(model, case):
    """A model state (on the CPU) of ``case``'s parameters and normalizers."""
    import torch

    state = model.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(case["params"][n])
    return state.replace(normalizers=case["normalizers"])


def _pod_state(trainer, case):
    """A train state of ``case``'s parameters and normalizers."""
    return trainer.init_train_state(state=_pod_model_state(trainer.model, case))


def host_barrier():
    """A barrier of the pod's processes on the host (a worker's gloo
    group): an NCCL barrier would spin in a kernel on the process's card
    while another process's turn runs there."""
    import torch.distributed as dist

    dist.barrier(group=POD_HOST_GROUP)


def _pod_model(case, agg_vjp, device):
    """The case's model, trainer and topology with ``agg_vjp``, on ``device``."""
    import copy

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    config = copy.deepcopy(case["config"])
    config["params"]["model"]["agg_vjp"] = agg_vjp
    model = get_model(config)
    check_mgn15(model.gnn_config, agg_vjp)
    return model, Trainer(model, config, device=device), model.topology_from_trajectory(case["traj"], device=device)


def in_process_pod_step(case, shape, devices, agg_vjp, timed=False, bands=None):
    """One step of the in-process ``RankGroup(*shape)`` over ``devices`` (a
    rank each) on the case's global batch (``bands``: on the overlap-banded
    layout, K7 forward): loss, gradients and parameters after Adam (CPU
    tensors); with ``timed``, a second step's host ms."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    group = RankGroup(*shape, devices=devices)
    model, trainer, topo = _pod_model(case, agg_vjp, group.device(0))
    step = make_spmd_train_step(trainer, shard_topology(topo, group, overlap_bands=bands), group)
    frames = trainer.frames(case["frames"])
    tstate, loss = step(_pod_state(trainer, case), frames, normal=case["normal"])
    group.check()
    out = dict(loss=loss.cpu(), grads={n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()},
               params={n: p.detach().cpu() for n, p in tstate.model.params.named_parameters()})
    if timed:
        tstate = _pod_state(trainer, case)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tstate, frames, normal=case["normal"])
        group.check()
        out["ms"] = 1e3 * (time.perf_counter() - t0)
    return out


def pod_run(rank, case, run):
    """One run of a pod worker on ``make_pod_group(graph_per_host=run["graph"],
    devices=run["devices"][rank])`` (:func:`pod_group`).  ``run["kind"]``
    ``halo``: :func:`pod_halo`; ``ring_times``: :func:`pod_ring_times`;
    ``ring_probe``: :func:`pod_ring_probe`; ``step`` (the default): the
    frames of the process's data rows, one counted train step (every count
    set to 0 just before, read just after; ``bands``: on the overlap-banded
    layout), its loss, gradients and parameters; with ``control``, the
    step's loss and gradients with the other processes' aggregate
    cotangents dropped (``RankGroup.cotangents`` returning this process's
    own); with ``timed``, that many pod steps timed on the host clock, each
    followed (``turns``) by a step of the in-process group of the same
    shape in process 0 (the others wait at a barrier)."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel import multihost
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    kind = run.get("kind", "step")
    group = pod_group(rank, run)
    if kind == "halo":
        return pod_halo(case, group, run["path"], timed=run.get("timed", 0), barrier=host_barrier)
    if kind == "ring_times":
        return pod_ring_times(rank, group, run)
    if kind == "ring_probe":
        return pod_ring_probe(group, run)
    model, trainer, topo = _pod_model(case, run["agg_vjp"], group.device(0))
    step = make_spmd_train_step(trainer, shard_topology(topo, group, overlap_bands=run.get("bands")), group)
    frames, rows = trainer.frames(case["frames"]), group.data_rows
    b = POD_FRAMES // group.shape["data"]
    batch = multihost.host_local_batch_to_global(
        {k: v[rows[0] * b : (rows[-1] + 1) * b] for k, v in frames.items()}, group)
    tstate = _pod_state(trainer, case)
    reset_counts()
    tstate, loss = step(tstate, batch, normal=case["normal"])
    group.check()
    out = dict(counts=read_counts(), loss=loss.cpu(), ranks=group.ranks,
               grads={n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()},
               params={n: p.detach().cpu() for n, p in tstate.model.params.named_parameters()})
    if run.get("control"):
        group.cotangents = lambda parts, r: list(parts)
        cstate = _pod_state(trainer, case)
        closs, _ = step.loss_and_grads(cstate, batch, normal=case["normal"])
        group.check()
        out.update(control_loss=closs.cpu(),
                   control_grads={n: p.grad.cpu() for n, p in cstate.model.params.named_parameters()})
        del group.cotangents
    pod_ms, in_process_ms = [], []
    if run.get("timed"):
        ref = None
        if rank == 0 and run.get("turns"):
            ref_group = RankGroup(*run["shape"], devices=[group.device(0)] * (run["shape"][0] * run["shape"][1]))
            ref = (ref_group, make_spmd_train_step(trainer, shard_topology(topo, ref_group), ref_group))
        for _ in range(run["timed"]):
            tstate = _pod_state(trainer, case)
            host_barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(tstate, batch, normal=case["normal"])
            group.check()
            pod_ms.append(1e3 * (time.perf_counter() - t0))
            if ref is not None:
                rstate = _pod_state(trainer, case)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref[1](rstate, frames, normal=case["normal"])
                ref[0].check()
                in_process_ms.append(1e3 * (time.perf_counter() - t0))
            host_barrier()
    out.update(ms=pod_ms, in_process_ms=in_process_ms)
    return out


def pod_group(rank, run):
    """Process ``rank``'s share of the pod of ``run``
    (``make_pod_group(graph_per_host=run["graph"], devices=run["devices"][rank])``),
    its shape checked."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel import multihost

    group = multihost.make_pod_group(graph_per_host=run["graph"],
                                     devices=[torch.device(d) for d in run["devices"][rank]])
    if (group.shape["data"], group.shape["graph"]) != tuple(run["shape"]):
        raise AssertionError(f"pod run {run['name']}: group {group.shape}, want {run['shape']}")
    POD_GROUPS.add(group)
    return group


def watch_error_words():
    """A worker's daemon thread: logs the first ring spin error of each pod
    group (its page-locked error word) as soon as a kernel writes it, before
    anything else in the process reports the trap that follows (NCCL's
    watchdog ends the process on it)."""
    from hyper_graph_nets_tpu_torch.parallel.group import WAIT_KINDS

    seen = set()
    while True:
        for group in list(POD_GROUPS):
            err = group._err
            if id(group) not in seen and err is not None and int(err[0]) != 0:
                seen.add(id(group))
                kind, rank, step, sub = (int(v) for v in err)
                log(f"ring spin error: rank {rank} waited past its time limit for {WAIT_KINDS.get(kind, kind)} "
                    f"(step {step}, sub-ring or band {sub}); group {group.shape}, ranks {group.ranks}, epoch "
                    f"{group.epoch}")
        time.sleep(0.02)


HALO_POD_PATHS = {"ring": ("xla", True, False, "K6"), "overlap": ("fused", False, True, "K7")}


def pod_halo(case, group, path, timed=0, barrier=None):
    """The halo forward of the case's frame 0 on ``group`` (a pod's share
    or an in-process group): ``path`` ``ring`` (``agg_vjp: xla``, K6) or
    ``overlap`` (fused on HALO_BANDS bands, K7), counted (every count set to
    0 just before, read just after): ``{"rows": {global rank: its output
    rows on the CPU}, "counts": ..., "ms": host ms of ``timed`` more
    forwards, each from a ``barrier``}``."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph
    from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology

    agg_vjp, ring, overlap, _ = HALO_POD_PATHS[path]
    dev = group.device(0)
    model, _, topo = _pod_model(case, agg_vjp, dev)
    state = _pod_model_state(model, case).to(dev)
    frame = {k: torch.as_tensor(v[0], device=dev) for k, v in case["traj"].items() if k != "cells"}
    with torch.no_grad():
        graph, _, _ = model.make_graph(state, shard_topology(topo, group, overlap_bands=HALO_BANDS if overlap
                                                             else None), frame, False)
    rank_graphs = split_graph(graph, group)
    fwd = make_halo_forward(model, group, ring=ring, overlap=overlap)
    torch.cuda.synchronize()
    reset_counts()
    outs = fwd(state, rank_graphs, all_ranks=True)
    counts = read_counts()
    ms = []
    for _ in range(timed):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(state, rank_graphs)
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(rows={q: o.cpu() for q, o in zip(group.ranks, outs)}, counts=counts, ms=ms)


def rank_event_ms(group, fn):
    """Each of the group's ranks' device ms for ``fn``, which enqueues one
    ring call on the ranks' streams: CUDA events on each rank's stream
    around it (the spins on a neighbour included)."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(group.n)]
    for r, (start, _) in enumerate(ev):
        start.record(group.stream(r))
    fn()
    for r, (_, end) in enumerate(ev):
        end.record(group.stream(r))
    group.check()
    return [start.elapsed_time(end) for start, end in ev]


def _shard_on(x, dev):
    """One rank's K7 shard arguments (``overlap_shards``) on ``dev``."""
    return {k: (v.to(dev) if hasattr(v, "to") else {n: w.to(dev) for n, w in v.items()}) for k, v in x.items()}


def pod_ring_times(rank, group, run):
    """K6 at the halo forward's payload ([4N, L] float32, the pna segments)
    and K7 at its shard (bf16, HALO_BANDS bands) on the pod's ranks, each
    rank's inputs made from ``run["seed"]`` by its global rank, against the
    in-process group of the pod's shape over the same cards (in process 0):
    one call of each counted and kept (the rows of every rank, CPU), K6
    held bit for bit against its plain version on the card, then
    POD_RING_REPS calls of each timed per rank by CUDA events (from a host
    barrier), each pod call followed by the in-process group's."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments, ring_all_reduce_segments_reference
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    D, G = group.shape["data"], group.shape["graph"]
    N, L = 1600, L_MAIN
    gen = torch.Generator().manual_seed(run["seed"])
    xs = [torch.randn(4 * N, L, generator=gen) for _ in range(D * G)]
    shards, N = overlap_shards(torch.bfloat16, gen, n=G)
    pna = [(0, N, "sum"), (N, 2 * N, "sum"), (2 * N, 3 * N, "max"), (3 * N, 4 * N, "min")]

    def inputs(g):
        return ([xs[q].to(g.device(r)) for r, q in enumerate(g.ranks)],
                [_shard_on(shards[g.axis_index(r, "graph")], g.device(r)) for r in range(g.n)])

    def calls(g, x6, x7):
        return (lambda: ring_all_reduce_segments(x6, pna, g),
                lambda: fused_edge_block_overlap(x7, N, g, HALO_BANDS))

    k6, k7 = calls(group, *inputs(group))
    ref = None
    if rank == 0:
        ref_group = RankGroup(D, G, devices=[torch.device(d) for ds in run["devices"] for d in ds])
        ref = (ref_group, *calls(ref_group, *inputs(ref_group)))
    torch.cuda.synchronize()
    reset_counts()
    got6, got7 = k6(), k7()
    group.check()
    counts = read_counts()
    for r, q in enumerate(group.ranks):
        members = group.members(r)
        plain = ring_all_reduce_segments_reference([xs[m].to(group.device(r)) for m in members], pna)
        if not torch.equal(got6[r], plain[members.index(q)]):
            raise AssertionError(f"pod K6, rank {q}: differs from its plain version")
    out = dict(counts=counts, k7={q: tuple(t.cpu() for t in o) for q, o in zip(group.ranks, got7)},
               ms={"K6": [], "K7": []}, in_process_ms={"K6": [], "K7": []})
    if ref is not None:
        ref_group, r6, r7 = ref
        r6()
        out["k7_in_process"] = {q: tuple(t.cpu() for t in o) for q, o in zip(ref_group.ranks, r7())}
        ref_group.check()
    for rep in range(POD_RING_REPS + 1):  # the first of each: warm-up
        for name, fn in (("K6", k6), ("K7", k7)):
            host_barrier()
            torch.cuda.synchronize()
            ms = rank_event_ms(group, fn)
            if rep:
                out["ms"][name].append(ms)
            host_barrier()
            if ref is not None:
                ms = rank_event_ms(ref[0], ref[1 if name == "K6" else 2])
                if rep:
                    out["in_process_ms"][name].append(ms)
    return out


def pod_ring_probe(group, run):
    """``run["reps"]`` K6 calls on [64, 128] float32 partials (seeded
    alike in every process) on the pod's ranks, each from a host barrier,
    counted, held bit for bit against the plain fold on the card and timed
    per rank by CUDA events (spins on the other process included) and on
    the host clock to the end of ``group.check()``; the plain fold's device
    ms on the same inputs."""
    import torch

    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments, ring_all_reduce_segments_reference

    gen = torch.Generator().manual_seed(run["seed"])
    segments = [(0, 64, "sum")]
    total = group.shape["data"] * group.shape["graph"]
    out = dict(counts=dict.fromkeys(read_counts(), 0), ms=[], host_ms=[])
    for _ in range(run["reps"]):
        xs = [torch.randn(64, 128, generator=gen) for _ in range(total)]
        mine = [xs[q].to(group.device(r)) for r, q in enumerate(group.ranks)]
        torch.cuda.synchronize()
        host_barrier()
        reset_counts()
        t0 = time.perf_counter()
        got = []
        out["ms"].append(rank_event_ms(group, lambda: got.extend(ring_all_reduce_segments(mine, segments, group))))
        out["host_ms"].append(1e3 * (time.perf_counter() - t0))
        out["counts"] = {k: out["counts"][k] + v for k, v in read_counts().items()}
        for r, q in enumerate(group.ranks):
            members = group.members(r)
            plain = ring_all_reduce_segments_reference([xs[m].to(group.device(r)) for m in members], segments)
            if not torch.equal(got[r], plain[members.index(q)]):
                raise AssertionError(f"pod K6 across processes on one card, rank {q}: differs from its plain version")
    row = [xs[m].to(group.device(0)) for m in group.members(0)]
    out["plain_ms"] = cuda_time_ms(lambda: ring_all_reduce_segments_reference(row, segments), iters=20)
    return out


def pod_worker(rank, world, port, src, dst):
    """One process of a pod (``--pod-worker``): the job's process group
    (``gloo``, or ``nccl`` with this process's first card as its current
    one) over TCP on 127.0.0.1, then each of the job's runs
    (:func:`pod_run`), each one's seconds logged; saves their results.
    Short of the job's time limit every thread's traceback is written to
    the worker's log, so that a worker killed at the limit shows where it
    stood."""
    import faulthandler
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    global POD_HOST_GROUP
    configure_numerics()
    job = torch.load(src, weights_only=False)
    limit = job.get("timeout", POD_TIMEOUT_S)
    faulthandler.dump_traceback_later(max(10, limit - 20))
    threading.Thread(target=watch_error_words, daemon=True).start()
    if job["backend"] == "nccl":
        torch.cuda.set_device(torch.device(job["runs"][0]["devices"][rank][0]))
    dist.init_process_group(job["backend"], init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=POD_TIMEOUT_S))
    if job["backend"] == "nccl":
        POD_HOST_GROUP = dist.new_group(backend="gloo", timeout=timedelta(seconds=POD_TIMEOUT_S))
    try:
        out = {}
        for run in job["runs"]:
            t0 = time.perf_counter()
            out[run["name"]] = pod_run(rank, job["case"], run)
            out[run["name"]]["seconds"] = time.perf_counter() - t0
            log(f"pod worker {rank}: {run['name']} in {out[run['name']]['seconds']:.1f} s")
        torch.save(out, dst)
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


def start_pod(job, processes, timeout=POD_TIMEOUT_S):
    """``processes`` workers of ``job`` (``python chip_smoke.py
    --pod-worker``), run to their end within ``timeout`` seconds (killed
    past it; each worker's log, in a file of its own, is shown on a
    failure): their results and the workers' wall seconds."""
    import socket
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "job.pt")
        torch.save(dict(job, timeout=timeout), src)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        outs = [os.path.join(tmp, f"out{r}.pt") for r in range(processes)]
        logs = [os.path.join(tmp, f"log{r}.txt") for r in range(processes)]
        t0 = time.perf_counter()
        procs = []
        for r in range(processes):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--pod-worker", str(r),
                                               str(processes), str(port), src, outs[r]],
                                              stdout=f, stderr=subprocess.STDOUT, text=True))
        late = False
        try:
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            late = True
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        text = []
        for r in range(processes):
            with open(logs[r]) as f:
                text.append(f.read())
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if late or failed:
            raise AssertionError(
                f"pod workers {'past their ' + str(timeout) + ' s limit' if late else 'failed'} (exit codes "
                f"{[p.returncode for p in procs]}):\n" + "\n".join(f"-- worker {r}:\n{t[-6000:]}" for r, t in
                                                                     enumerate(text)))
        return [torch.load(o, weights_only=False) for o in outs], wall_s


def pod_same(results, name):
    """Whether every process's loss, gradients and parameters of run
    ``name`` equal process 0's bit for bit."""
    import torch

    p0 = results[0][name]
    return all(torch.equal(p0["loss"], res[name]["loss"]) and all(
        torch.equal(p0[k][n], res[name][k][n]) for k in ("params", "grads") for n in p0[k]) for res in results[1:])


def pod_equal(got, ref):
    """The names of the gradients and parameters (and ``loss``) where a pod
    process's run differs from the in-process step's by a bit."""
    import torch

    bad = [] if torch.equal(got["loss"], ref["loss"]) else ["loss"]
    return bad + [f"{k} {n}" for k in ("grads", "params") for n in ref[k] if not torch.equal(got[k][n], ref[k][n])]


def phase_pod(card, peaks, seed):
    """The pod (``parallel.multihost``) in POD_PROCESSES processes that share
    the card over ``gloo``: flag_full_scale with RMP off (bf16, 15 blocks,
    latent 128) at a global B = POD_FRAMES, in two layouts of one pair of
    worker processes.

    - 2 x 2 (``make_pod_group(graph_per_host=POD_GRAPH, devices=[cuda:0,
      cuda:0])``: a data row each process, ``graph`` inside), fused: K1 raw
      and K2 per shard (30 of each a process); against the in-process
      ``RankGroup(2, 2)`` step on the card (loss and Adam updates within
      ``SPMD_TOL``, every summed gradient within ``POD_GRAD_TOL``), the
      processes bit for bit.
    - 1 x 2 (``devices=[cuda:0]``: the one ``graph`` row across the two
      processes), fused (15 K1 raw + 15 K2 a process, the aggregates and
      their cotangents gathered across the processes) and sorted (15 K4f +
      15 K4b a process on the row's shards joined across the processes):
      loss, every gradient and the update bit for bit with the in-process
      ``RankGroup(1, 2)`` on the card; the planted control (the other
      process's cotangents dropped) must miss ``SPMD_TOL``; the fused pod
      step's host ms in each process beside the in-process step's, in
      turns.
    - 1 x 2 again: POD_RING_PROBE_REPS K6 calls on [64, 128] float32 across
      the two processes on the one card (``pod_ring_probe``: each rank's
      neighbour in the other process reached over CUDA IPC, the two
      processes' kernels time-sliced), each bit for bit with the plain fold,
      timed per rank by CUDA events and on the host clock.

    K1 raw and K2 at each layout's shard, K4f and K4b on the joined row,
    against their plain versions."""
    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology

    case = pod_case(seed)
    blocks = 15
    refs = {"2x2": in_process_pod_step(case, (POD_PROCESSES, POD_GRAPH), ["cuda:0"] * 4, "fused", timed=True)}
    for agg_vjp in ("fused", "sorted"):
        refs[f"1x2 {agg_vjp}"] = in_process_pod_step(case, (1, POD_GRAPH), ["cuda:0"] * 2, agg_vjp)
    # the workers share the card with this process: hand back its unused cache first
    torch.cuda.empty_cache()
    one, two = ["cuda:0"], ["cuda:0", "cuda:0"]
    runs = [dict(name="2x2", graph=POD_GRAPH, devices=[two] * POD_PROCESSES, shape=(2, 2), agg_vjp="fused",
                 timed=1),
            dict(name="1x2 fused", graph=POD_GRAPH, devices=[one] * POD_PROCESSES, shape=(1, 2), agg_vjp="fused",
                 control=True, timed=POD_TIMED, turns=True),
            dict(name="1x2 sorted", graph=POD_GRAPH, devices=[one] * POD_PROCESSES, shape=(1, 2), agg_vjp="sorted"),
            dict(name="1x2 ring", kind="ring_probe", graph=POD_GRAPH, devices=[one] * POD_PROCESSES, shape=(1, 2),
                 reps=POD_RING_PROBE_REPS, seed=seed + 53)]
    results, wall_s = start_pod(dict(backend="gloo", case=case, runs=runs), POD_PROCESSES)

    wants = {"2x2": dict(K1=blocks * POD_GRAPH, K2=blocks * POD_GRAPH), "1x2 fused": dict(K1=blocks, K2=blocks),
             "1x2 sorted": dict(K4f=blocks, K4b=blocks), "1x2 ring": dict(K6=POD_RING_PROBE_REPS)}
    launches = dict.fromkeys(read_counts(), 0)
    by_run = {}
    for name, counts in wants.items():
        want = dict.fromkeys(read_counts(), 0)
        want.update(counts)
        by_run[name] = dict.fromkeys(want, 0)
        for r, res in enumerate(results):
            if res[name]["counts"] != want:
                raise AssertionError(f"pod {name}, process {r}: launches {res[name]['counts']}, want {want}")
            for k in launches:
                launches[k] += res[name]["counts"][k]
                by_run[name][k] += res[name]["counts"][k]
        if name != "1x2 ring" and not pod_same(results, name):
            raise AssertionError(f"pod {name}: the processes' loss, gradients or parameters differ")

    # 2 x 2: against the in-process step within the limits
    p0, ref = results[0]["2x2"], refs["2x2"]
    loss_tol, grad_tol = SPMD_TOL["bfloat16"]
    loss_err = abs(float(p0["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    before = case["params"]
    update = lambda params, n: params[n].float() - before[n].float()
    worst = max((rel_l2(update(p0["params"], n), update(ref["params"], n)), n) for n in ref["params"])
    worst_grad = max((rel_l2(p0["grads"][n], ref["grads"][n]), n) for n in ref["grads"])
    log(f"pod 2 x 2 ({POD_PROCESSES} processes, a data row each) vs in-process 2 x 2, global B={POD_FRAMES}: loss "
        f"{float(p0['loss']):.6f} / {float(ref['loss']):.6f} (rel {loss_err:.3g}); worst Adam update rel L2 "
        f"{worst[0]:.3g} ({worst[1]}); limits {SPMD_TOL['bfloat16']}; worst summed gradient rel L2 "
        f"{worst_grad[0]:.3g} ({worst_grad[1]}; limit {POD_GRAD_TOL}); the processes bit for bit; step host ms "
        f"{results[0]['2x2']['ms'][0]:.1f} / {results[1]['2x2']['ms'][0]:.1f} (processes) vs {ref['ms']:.1f} "
        f"(in-process) [{card}]")
    if not (np.isfinite(float(p0["loss"])) and loss_err <= loss_tol and worst[0] <= grad_tol
            and worst_grad[0] <= POD_GRAD_TOL):
        raise AssertionError(f"pod 2 x 2 vs in-process: loss rel {loss_err:.3g}, worst update {worst}, worst "
                             f"gradient {worst_grad}, limits {SPMD_TOL['bfloat16']}, gradients {POD_GRAD_TOL}")

    # 1 x 2, graph across the processes: bit for bit with the in-process 1 x 2
    timings = dict(loss=float(p0["loss"]), ref_loss=float(ref["loss"]), loss_rel_err=loss_err,
                   worst_update_rel_l2=worst[0], worst_update=worst[1], worst_grad_rel_l2=worst_grad[0],
                   worst_grad=worst_grad[1], pod_2x2_step_host_ms=[res["2x2"]["ms"][0] for res in results],
                   in_process_2x2_step_host_ms=ref["ms"], workers_wall_s=wall_s, launches_by_run=by_run)
    for name in ("1x2 fused", "1x2 sorted"):
        for r, res in enumerate(results):
            bad = pod_equal(res[name], refs[name])
            if bad:
                raise AssertionError(f"pod {name}, process {r}: differs from the in-process 1 x 2 step in "
                                     f"{len(bad)} of loss, gradients and parameters: {bad[:5]}")
        timings[f"{name} loss"] = float(results[0][name]["loss"])
    fused = [res["1x2 fused"] for res in results]
    ref = refs["1x2 fused"]
    control = max((rel_l2(fused[0]["control_grads"][n], ref["grads"][n]), n) for n in ref["grads"])
    if control[0] <= grad_tol or not torch.equal(fused[0]["control_loss"], ref["loss"]):
        raise AssertionError(f"pod 1 x 2: the control without the other process's cotangents read {control} "
                             f"(limit {grad_tol} must be missed), loss {float(fused[0]['control_loss'])}")
    timings.update(control_worst_grad_rel_l2=control[0], control_worst_grad=control[1],
                   pod_step_host_ms=[res["ms"] for res in fused], in_process_1x2_step_host_ms=fused[0]["in_process_ms"])
    log(f"pod 1 x 2 (the graph row across {POD_PROCESSES} processes on one card, gloo), global B={POD_FRAMES}: fused "
        f"(15 K1 raw + 15 K2 a process) and sorted (15 K4f + 15 K4b a process) bit for bit with the in-process "
        f"RankGroup(1, 2) on the card (loss {timings['1x2 fused loss']:.6f}, {timings['1x2 sorted loss']:.6f}); "
        f"without the other process's cotangents the worst gradient rel L2 {control[0]:.3g} ({control[1]}) misses "
        f"{grad_tol}; fused step host ms {', '.join(f'{t:.1f}' for t in fused[0]['ms'])} (process 0), "
        f"{', '.join(f'{t:.1f}' for t in fused[1]['ms'])} (process 1) against the in-process step's "
        f"{', '.join(f'{t:.1f}' for t in fused[0]['in_process_ms'])} in turns; workers {wall_s:.1f} s [{card}]")

    # the kernels at the processes' shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    rows = {}
    for tag, shape, Bk in (("pod shard", (POD_PROCESSES, POD_GRAPH), POD_FRAMES // POD_PROCESSES),
                           ("pod row shard", (1, POD_GRAPH), POD_FRAMES)):
        _, _, topo = _pod_model(case, "fused", "cuda")
        ptopo = shard_topology(topo, RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1])))
        sl = ptopo.layout.shard(0)
        snd, rcv = ptopo.senders.cpu().numpy()[sl], ptopo.receivers.cpu().numpy()[sl]
        mask = ptopo.mask.cpu().numpy()[sl]
        got, _ = shard_kernel_rows(tag, peaks, gen, snd, rcv, mask, ptopo.plan.plans[0], 1600, Bk, seed + 43)
        rows.update({k if tag == "pod shard" else f"{k} row": v for k, v in got.items()})
    _, _, stopo = _pod_model(case, "sorted", "cuda")
    stopo = shard_topology(stopo, RankGroup(1, POD_GRAPH, devices=["cuda:0"] * POD_GRAPH))
    rows.update({f"{k} row": v for k, v in sorted_joined_rows(peaks, gen, stopo, POD_FRAMES).items()})

    # K6 across the two processes on the one card (CUDA IPC, the kernels time-sliced)
    import statistics

    probe = [res["1x2 ring"] for res in results]
    per_call = [max(ms) for res in probe for ms in res["ms"]]
    rows["K6 across processes"] = dict(
        ms=statistics.median(per_call), plain_ms=probe[0]["plain_ms"], max_abs_err=0.0,
        **{k: ring_bounds_ms(POD_GRAPH, 64 * 128 * 4, peaks)[k] for k in ("bound_ms", "bound_by")},
        shape=f"float32 [64, 128], 1 x 2 across {POD_PROCESSES} processes on one card")
    timings["1x2 ring"] = dict(ms_by_process=[res["ms"] for res in probe],
                               host_ms_by_process=[res["host_ms"] for res in probe])
    log(f"pod 1 x 2, K6 across {POD_PROCESSES} processes on one card (CUDA IPC, time-sliced): "
        f"{POD_RING_PROBE_REPS} calls a process on [64, 128] float32, each bit for bit with the plain fold; device "
        f"ms per call (slower rank) median {rows['K6 across processes']['ms']:.3f}, max {max(per_call):.3f}; host ms "
        f"(process 0) median {statistics.median(probe[0]['host_ms']):.3f}; plain {probe[0]['plain_ms']:.4f} ms "
        f"[{card}]")
    return launches, timings, rows


def phase_pod_cards(card, peaks, seed):
    """The pod over ``nccl``, each process on cards of its own: with fewer
    than two cards one line ``{"phase": "pod_cards", "ran": false,
    "cards": N}`` and nothing else (not a pass).  On four or more cards the
    layouts of POD_CARDS_LAYOUTS: 2 processes x 2 cards with
    ``graph_per_host`` 4 (a 1 x 4 pod, the row across both) and 4 x 1 with
    2 (2 x 2: each row across two processes, each ``data`` column across
    two); on two or three, 2 x 1 with 2 (1 x 2).  flag_full_scale with RMP
    off (bf16, 15 blocks, latent 128) at a global B = POD_FRAMES, in each
    layout: the fused step (15 K1 raw + 15 K2 a rank) and the
    overlap-banded step (HALO_BANDS bands: 15 K7 + 15 K2 a rank), each
    process's loss, every gradient and its parameters after Adam bit for bit
    with the in-process group of the same shape over the same cards (a rank
    a card), the processes bit for bit, the steps' host ms; the halo
    forward of frame 0 with ``ring`` (15 K6 a rank, the ring across the
    processes over CUDA IPC) and with ``overlap`` (15 K7 a rank), every
    rank's rows bit for bit with the in-process group's, host ms (the
    in-process group's taken before the workers start).  On the
    first layout (1 x 4) also K6 and K7 at the halo forward's shapes timed
    per rank by CUDA events, POD_RING_REPS calls each in turns with the
    in-process group over the same four cards (``pod_ring_times``), K7's
    rows bit for bit with the in-process group's.  Each process's K6 and K7
    launches go into the phase's counts."""
    import torch

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    cards = torch.cuda.device_count()
    launches = dict.fromkeys(read_counts(), 0)
    if cards < 2:
        print(json.dumps({"phase": "pod_cards", "ran": False, "cards": cards}), flush=True)
        log(f"pod_cards: not run, {cards} card: NCCL takes one card a process, so the pod over nccl needs two or more")
        return launches, {"ran": False, "cards": cards}
    case = pod_case(seed)
    layouts = POD_CARDS_LAYOUTS if cards >= 4 else (POD_CARDS_SMALL,)
    timings = {"ran": True, "cards": cards}
    for li, ((processes, per, graph), shape) in enumerate(layouts):
        name = f"{shape[0]}x{shape[1]} ({processes} processes x {per} cards)"
        devices = [[f"cuda:{p * per + i}" for i in range(per)] for p in range(processes)]
        flat = [d for ds in devices for d in ds]
        refs = {"step": in_process_pod_step(case, shape, flat, "fused", timed=True),
                "overlap step": in_process_pod_step(case, shape, flat, "fused", timed=True, bands=HALO_BANDS)}
        for path in HALO_POD_PATHS:
            refs[f"halo {path}"] = pod_halo(case, RankGroup(*shape, devices=flat), path, timed=POD_HALO_TIMED)
        torch.cuda.empty_cache()
        base = dict(graph=graph, devices=devices, shape=shape)
        runs = [dict(base, name="ring times", kind="ring_times", seed=seed + 47)] if li == 0 and cards >= 4 else []
        runs += [dict(base, name=f"halo {path}", kind="halo", path=path, timed=POD_HALO_TIMED)
                 for path in HALO_POD_PATHS]
        runs += [dict(base, name="step", agg_vjp="fused", timed=2),
                 dict(base, name="overlap step", agg_vjp="fused", bands=HALO_BANDS, timed=2)]
        results, wall_s = start_pod(dict(backend="nccl", case=case, runs=runs), processes, POD_CARDS_TIMEOUT_S)
        blocks = 15
        wants = {"step": dict(K1=blocks * per, K2=blocks * per), "overlap step": dict(K7=blocks * per, K2=blocks * per),
                 **{f"halo {path}": {HALO_POD_PATHS[path][3]: blocks * per} for path in HALO_POD_PATHS}}
        row = dict(workers_wall_s=wall_s, launches_per_process={})
        for run_name, counts in wants.items():
            want = dict.fromkeys(read_counts(), 0)
            want.update(counts)
            row["launches_per_process"][run_name] = counts
            for r, res in enumerate(results):
                got = res[run_name]
                if got["counts"] != want:
                    raise AssertionError(f"pod over nccl {name} {run_name}, process {r}: launches {got['counts']}, "
                                         f"want {want}")
                if run_name.startswith("halo"):
                    bad = [q for q, rows in got["rows"].items() if not torch.equal(rows, refs[run_name]["rows"][q])]
                    if bad:
                        raise AssertionError(f"pod over nccl {name} {run_name}, process {r}: ranks {bad} differ from "
                                             "the in-process group's rows")
                else:
                    bad = pod_equal(got, refs[run_name])
                    if bad:
                        raise AssertionError(f"pod over nccl {name} {run_name}, process {r}: differs from the "
                                             f"in-process group over the same cards in {len(bad)} of loss, gradients "
                                             f"and parameters: {bad[:5]}")
                for k in launches:
                    launches[k] += got["counts"][k]
            ref_ms = refs[run_name]["ms"]
            row[run_name] = dict(host_ms=[res[run_name]["ms"] for res in results],
                                 in_process_host_ms=ref_ms if isinstance(ref_ms, list) else [ref_ms])
            if not run_name.startswith("halo"):
                row[run_name]["loss"] = float(results[0][run_name]["loss"])
        line = "; ".join(f"{k} {', '.join(f'{t:.1f}' for t in row[k]['host_ms'][0])} (in-process "
                         f"{', '.join(f'{t:.1f}' for t in row[k]['in_process_host_ms'])})" for k in wants)
        if any(run["kind"] == "ring_times" for run in runs if "kind" in run):
            ring = pod_ring_summary(results, name)
            row["ring times"] = ring
            line += "; " + ring["text"]
        timings[name] = row
        log(f"pod over nccl {name}: {shape[0]} x {shape[1]} on {', '.join(flat)}, global B={POD_FRAMES}; per rank "
            f"15 K1 raw + 15 K2 (step), 15 K7 + 15 K2 (overlap step), 15 K6 (halo ring), 15 K7 (halo overlap) in "
            f"each process; loss, gradients, parameters and halo rows bit for bit with the in-process group over the "
            f"same cards; host ms (process 0): {line}; workers {wall_s:.1f} s [{card}]")
    return launches, timings


def pod_ring_summary(results, name):
    """The ``ring times`` run of a pod's processes: K7's rows bit for bit
    with the in-process group's (process 0 ran it), and each kernel's
    per-rank device ms, median over the timed calls, the pod's beside the
    in-process group's."""
    import statistics

    import torch

    ref = results[0]["ring times"]["k7_in_process"]
    for r, res in enumerate(results):
        for q, (e2, agg) in res["ring times"]["k7"].items():
            if not (torch.equal(e2, ref[q][0]) and torch.equal(agg, ref[q][1])):
                raise AssertionError(f"pod over nccl {name}, K7 across processes, rank {q} (process {r}): differs from "
                                     "the in-process group's")
    med = lambda runs: [statistics.median(col) for col in zip(*runs)]
    out = {"pod_ms_by_process": {k: [med(res["ring times"]["ms"][k]) for res in results] for k in ("K6", "K7")},
           "in_process_ms": {k: med(results[0]["ring times"]["in_process_ms"][k]) for k in ("K6", "K7")},
           "reps": POD_RING_REPS}
    fmt = lambda xs: "/".join(f"{x * 1e3:.0f}" for x in xs)
    out["text"] = "; ".join(
        f"{k} us per rank across processes {' | '.join(fmt(p) for p in out['pod_ms_by_process'][k])} vs in-process "
        f"{fmt(out['in_process_ms'][k])} (medians of {POD_RING_REPS}, in turns)" for k in ("K6", "K7"))
    return out


# -- the sharded step over several cards ----------------------------------------------

SPMD_CARDS_MAX = 4  # cards a group's 4 ranks spread over: rank r on cuda:(r % cards)
SPMD_CARDS_STEPS = 3  # steps of each run before the copies are held bit for bit
SPMD_CARDS_TIMED = 3  # timed steps of the spread group and of the one-card group, in turns


@contextlib.contextmanager
def launches_by_card():
    """``{kernel: {card: launches}}`` of K1, K2 and K7 while the block runs,
    tallied by the card of the tensors each launch is given (K7: every
    rank's shard) around the launchers; their totals must equal
    ``read_counts``'.  K7's wrapper takes over its count while it is in
    place (the launcher adds to whatever its module's name points at)."""
    from collections import Counter

    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.ops import fused_overlap as fo

    tally = {k: Counter() for k in ("K1", "K2", "K7")}
    k1, k2, k7 = fb._k1_launch, fb._bwd_launch, fo.fused_edge_block_overlap

    def on_k1(e, *args, **kwargs):
        out = k1(e, *args, **kwargs)
        tally["K1"][e.device.index] += 1
        return out

    def on_k2(stream_mode, e, *args, **kwargs):
        out = k2(stream_mode, e, *args, **kwargs)
        tally["K2"][e.device.index] += int(not stream_mode)  # K3 shares the launcher
        return out

    def on_k7(shards, *args, **kwargs):
        out = k7(shards, *args, **kwargs)
        for x in shards:
            tally["K7"][x["e"].device.index] += 1
        return out

    on_k7.launches = k7.launches
    fb._k1_launch, fb._bwd_launch, fo.fused_edge_block_overlap = on_k1, on_k2, on_k7
    try:
        yield tally
    finally:
        fb._k1_launch, fb._bwd_launch, fo.fused_edge_block_overlap = k1, k2, k7
        k7.launches = on_k7.launches


def phase_spmd_cards(card, peaks, seed):
    """The sharded step over several cards in one process: with fewer than
    two cards one line ``{"phase": "spmd_cards", "ran": false, "cards":
    N}`` and nothing else (not a pass).  With two or more,
    flag_full_scale with RMP off (bf16, 15 blocks, latent 128, fused remat)
    through ``make_spmd_train_step`` on the groups of SPMD_GROUPS spread
    over ``min(SPMD_CARDS_MAX, cards)`` cards: one counted step (K1 raw or
    K7 and K2, per card), its loss and gradients against the same group on
    one card (SPMD_TOL bf16); a step with the cross-card gradient sum left
    out, which must miss the gradient limit; two runs of SPMD_CARDS_STEPS
    steps from one state, bit for bit, with every card's parameter copy
    equal to the state's parameters bit for bit; the step's host ms beside
    the one-card group's, in turns.  Under the sharded phases' watchdog."""
    import faulthandler

    import numpy as np
    import torch

    from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
    from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    cards = torch.cuda.device_count()
    launches = dict.fromkeys(read_counts(), 0)
    if cards < 2:
        print(json.dumps({"phase": "spmd_cards", "ran": False, "cards": cards}), flush=True)
        log(f"spmd_cards: not run, {cards} card: the sharded step over several cards needs two or more")
        return launches, {"ran": False, "cards": cards}
    faulthandler.dump_traceback_later(SPMD_WATCHDOG_S, exit=True)
    n = min(SPMD_CARDS_MAX, cards)
    B_max = max(b for _, _, b in SPMD_GROUPS)
    traj = add_targets(flag_trajectory(num_steps=B_max + 2, nx=40, ny=40, seed=seed), "world_pos", history=True)
    every = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
    config = main_config()
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    model = get_model(config)
    check_mgn15(model.gnn_config)
    blocks = model.gnn_config.message_passing_steps
    trainer = Trainer(model, config)
    state = model.init_state(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # normalizers over the trajectory, as a run's would be
        _, _, state = model.make_graph(state, model.topology_from_trajectory(traj, device="cpu"), every, True)
        _, state = model.get_target(state, every, True)
    topo = model.topology_from_trajectory(traj, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 51)
    grads_of = lambda params: {k: p.grad.detach().clone() for k, p in params.named_parameters()}
    loss_tol, grad_tol = SPMD_TOL["bfloat16"]
    timings = {"ran": True, "cards": cards, "spread_over": n}

    def errors(loss, grads, ref_loss, ref_grads):
        loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        return loss_err, max((rel_l2(grads[k].to(ref_grads[k].device), ref_grads[k]), k) for k in ref_grads)

    for shape, bands, B in SPMD_GROUPS:
        ranks = shape[0] * shape[1]
        tag = f"{shape[0]}x{shape[1]}" + (f" overlap {bands}" if bands else "")
        kernel = "K7" if bands else "K1"
        spread = RankGroup(*shape, devices=[f"cuda:{r % n}" for r in range(ranks)])
        one = RankGroup(*shape, devices=["cuda:0"] * ranks)
        frames = {k: v[:B].cuda() for k, v in every.items()}
        normal = torch.randn(frames["world_pos"].shape, generator=gen, device="cuda")
        stopo = {g: shard_topology(topo, grp, overlap_bands=bands) for g, grp in (("one", one), ("spread", spread))}
        step = lambda g: make_spmd_train_step(trainer, stopo[g], spread if g == "spread" else one)
        ts = trainer.init_train_state(state=state)
        ref_loss, _ = step("one").loss_and_grads(ts, frames, normal=normal)
        one.check()
        ref_grads = grads_of(ts.model.params)

        # the main path: every count set to 0 just before, read just after
        sstep = step("spread")
        reset_counts()
        with launches_by_card() as per_card:
            loss, _ = sstep.loss_and_grads(ts, frames, normal=normal)
            spread.check()
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want[kernel] = want["K2"] = blocks * ranks
        on_card = {c: sum(d.index == c for d in spread.devices) for c in range(n)}
        by_card = {k: dict(sorted(per_card[k].items())) for k in (kernel, "K2")}
        want_by_card = {c: blocks * on_card[c] for c in range(n)}
        if counts != want or any(by_card[k] != want_by_card for k in by_card):
            raise AssertionError(f"sharded step over {n} cards {tag}: launches {counts}, by card {by_card}; want "
                                 f"{want}, {want_by_card} a card")
        for k in launches:
            launches[k] += counts[k]
        loss_err, worst = errors(loss, grads_of(ts.model.params), ref_loss, ref_grads)
        if not (np.isfinite(float(loss)) and loss_err <= loss_tol and worst[0] <= grad_tol):
            raise AssertionError(f"sharded step over {n} cards {tag} vs one card: loss rel {loss_err:.3g}, worst "
                                 f"gradient {worst}, limits {SPMD_TOL['bfloat16']}")

        # the planted control: the cross-card gradient sum left out
        planted = step("spread")
        planted._sum_over_devices = lambda params, per_device: None
        ploss, _ = planted.loss_and_grads(ts, frames, normal=normal)
        spread.check()
        p_loss_err, p_worst = errors(ploss, grads_of(ts.model.params), ref_loss, ref_grads)
        if p_worst[0] <= grad_tol:
            raise AssertionError(f"sharded step over {n} cards {tag}: without the cross-card sum the gradients "
                                 f"passed the limit {grad_tol}: {p_worst}")

        # two runs of SPMD_CARDS_STEPS steps from one state: the copies and the runs bit for bit
        runs = []
        for _ in range(2):
            rstep, tst = step("spread"), trainer.init_train_state(state=state)
            for _ in range(SPMD_CARDS_STEPS):
                tst, last = rstep(tst, frames, normal=normal)
            spread.check()
            home = {k: p.detach().cpu() for k, p in tst.model.params.named_parameters()}
            for d, kept in rstep.copies.items():
                for k, p in kept.named_parameters():
                    if not torch.equal(p.detach().cpu(), home[k]):
                        raise AssertionError(f"sharded step over {n} cards {tag}: the copy on {d} differs from the "
                                             f"state's {k} after {SPMD_CARDS_STEPS} steps")
            runs.append((last.cpu(), home, sorted(str(d) for d in rstep.copies)))
        if not (torch.equal(runs[0][0], runs[1][0]) and all(torch.equal(runs[0][1][k], runs[1][1][k])
                                                             for k in runs[0][1])):
            raise AssertionError(f"sharded step over {n} cards {tag}: two runs from one state differ")

        # host ms a step, the spread group and the one-card group in turns
        states = {g: trainer.init_train_state(state=state) for g in ("one", "spread")}
        steps = {"one": step("one"), "spread": rstep}
        ms = {g: [] for g in steps}
        for i in range(1 + SPMD_CARDS_TIMED):
            for g in steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[g], _ = steps[g](states[g], frames, normal=normal)
                (spread if g == "spread" else one).check()
                if i:  # the first of each is the warm-up
                    ms[g].append(1e3 * (time.perf_counter() - t0))
        timings[tag] = dict(
            B=B, ranks=ranks, devices=[str(d) for d in spread.devices], launches=counts, launches_by_card=by_card,
            loss_rel_err=loss_err, worst_grad_rel_l2=worst[0], worst_grad=worst[1],
            planted_worst_grad_rel_l2=p_worst[0], planted_worst_grad=p_worst[1], copies=runs[0][2],
            step_host_ms=ms["spread"], one_card_step_host_ms=ms["one"],
        )
        log(f"sharded step over {n} cards {tag} (flag MGN-15MP bf16, 40x40, B={B}, {ranks} ranks on "
            f"{', '.join(str(d) for d in spread.devices)}): {kernel} by card {by_card[kernel]}, K2 by card "
            f"{by_card['K2']}; vs the one-card group: loss rel {loss_err:.3g}, worst gradient rel L2 {worst[0]:.3g} "
            f"({worst[1]}), limits {SPMD_TOL['bfloat16']}; without the cross-card sum {p_worst[0]:.3g} "
            f"({p_worst[1]}) misses; copies on {runs[0][2]} bit for bit after {SPMD_CARDS_STEPS} steps, two runs bit "
            f"for bit; host ms a step {', '.join(f'{t:.1f}' for t in ms['spread'])} against one card's "
            f"{', '.join(f'{t:.1f}' for t in ms['one'])} (in turns) [{card}]")
    faulthandler.cancel_dump_traceback_later()
    return launches, timings


PHASE_SECONDS = []  # (phase, seconds) in run order, for --out


def timed(phase, *args):
    """``phase(*args)`` with its wall time logged: where the script's own
    time limit goes."""
    t0 = time.perf_counter()
    out = phase(*args)
    seconds = time.perf_counter() - t0
    PHASE_SECONDS.append((phase.__name__, seconds))
    log(f"{phase.__name__}: {seconds:.1f} s")
    return out


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
    ap.add_argument("--pod-worker", nargs=5, metavar=("RANK", "WORLD", "PORT", "IN", "OUT"),
                    help=argparse.SUPPRESS)  # one process of phase_pod's pod (started by the script)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hyper_graph_nets_tpu_torch")):
        print("chip_smoke: the port's package is not beside this file", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.pod_worker:
        rank, world, port, src, dst = args.pod_worker
        pod_worker(int(rank), int(world), int(port), src, dst)
        return 0
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
    k1 = timed(phase_kernels, card, peaks, topo_np, args.seed)
    bwd = timed(phase_backward, card, peaks, topo_np, args.seed)
    k4 = timed(phase_sorted, card, peaks, topo_np, args.seed)
    k5 = timed(phase_maxprod, card, peaks, topo_np, args.seed)
    sdrf_run = timed(phase_sdrf, card, topo_np)
    k6 = timed(phase_ring, card, peaks, args.seed)
    k7 = timed(phase_overlap, card, peaks, args.seed)
    model_kernels = timed(phase_model_kernels, card, peaks, args.seed)
    hgn_kernels = timed(phase_hgn_kernels, card, peaks, args.seed)

    # 4-5. the main paths, their counts and timings
    serve_launches, serve_timings = {}, {}
    for agg_vjp, balancer in (("fused", False), ("sorted", False), ("fused", True)):
        name = "fused_balancer" if balancer else agg_vjp
        n, serve_timings[name] = timed(phase_slice, card, args.seed, ROLLOUT_STEPS, args.profile, agg_vjp, balancer)
        serve_launches = {k: serve_launches.get(k, 0) + v for k, v in n.items()}
    halo_launches, halo_timings = timed(phase_halo, card, args.seed)
    spmd_launches, spmd_timings, spmd_rows = timed(phase_spmd, card, peaks, args.seed, args.profile)
    spmd_rmp_launches, spmd_rmp_timings, spmd_rmp_rows = timed(phase_spmd_rmp, card, peaks, args.seed, args.profile)
    spmd_models_launches, spmd_models_timings, spmd_models_rows = timed(
        phase_spmd_models, card, peaks, args.seed, args.profile)
    spmd_arch_launches, spmd_arch_timings = timed(phase_spmd_arch, card, peaks, args.seed)
    hybrid_launches, hybrid_timings, hybrid_rows = timed(phase_hybrid, card, peaks, args.seed)
    train_launches, train_timings = timed(phase_train, card, args.seed, args.profile)
    task_launches, task_timings = timed(phase_task, card)
    rmp_launches, rmp_timings, rmp_kernels = timed(phase_rmp, card, peaks, args.seed, args.profile)
    model_runs = {
        name: timed(phase_model, card, peaks, args.seed, name, args.profile) for name in ("cylinder", "plate")
    }
    bucketed_launches, bucket_timings, bucket_rows = timed(phase_bucketed, card, peaks, args.seed, args.profile)
    hgn_launches, hgn_timings = timed(phase_hgn, card, peaks, args.seed, args.profile)
    int8_launches, int8_timings = timed(phase_int8, card, args.seed, args.profile)
    cluster_launches, cluster_timings, cluster_rows = timed(phase_cluster, card, peaks, args.seed)
    pod_launches, pod_timings, pod_rows = timed(phase_pod, card, peaks, args.seed)
    pod_cards_launches, pod_cards_timings = timed(phase_pod_cards, card, peaks, args.seed)
    cards_launches, cards_timings = timed(phase_spmd_cards, card, peaks, args.seed)
    cli_timings = timed(phase_cli, card)
    launches = {
        k: serve_launches[k] + halo_launches[k] + spmd_launches[k] + spmd_rmp_launches[k] + spmd_models_launches[k]
        + spmd_arch_launches[k] + hybrid_launches[k] + train_launches[k]
        + task_launches[k] + rmp_launches[k]
        + sum(run[0][k] for run in model_runs.values()) + bucketed_launches[k] + hgn_launches[k] + int8_launches[k]
        + cluster_launches[k] + pod_launches[k] + pod_cards_launches[k] + cards_launches[k]
        for k in serve_launches
    }

    main_k1 = k1[("bfloat16", ONE_STEP_FRAMES)]
    k1_shapes = {"B=21": main_k1, "B=1": k1[("bfloat16", 1)], "B=15": k1[("bfloat16", TASK_LAST_BATCH)],
                 "B=32": k1[("bfloat16", TASK_N_STEP_CHUNK)], "raw shard": k1[("bfloat16 raw shard", 1)],
                 "raw contiguous shard": k1[("bfloat16 raw contiguous shard", 1)]}
    shapes = lambda runs: {tag: {"ms": r["ms"], "bound_ms": r["bound_ms"]} for tag, r in runs.items()}
    row = lambda r: {f: r[f] for f in ("ms", "bound_ms", "plain_ms", "max_abs_err", "f64_errors")
                     if f in r}
    path_rows = lambda k: {
        f"B=21 rows={1600 + RMP_CLUSTERS} (RMP)": row(rmp_kernels[k]),
        **{f"float32 B={MODEL_FRAMES} N={MODEL_SIZES[n][0]} E={MODEL_SIZES[n][1]} ({n})": row(mk[k])
           for n, mk in model_kernels.items()},
        **{f"float32 B={MODEL_FRAMES} rows={bucket_timings[n]['capacity'][0]} E={bucket_timings[n]['capacity'][1]} "
           f"(bucketed {n}, padded)": row(br[k]) for n, br in bucket_rows.items()},
        **{f"float32 B={MODEL_FRAMES} rows={MODEL_SIZES['plate'][0] + HGN_CLUSTERS} (HGN plate {n}"
           + (", fused_tiers)" if n in HGN_TIER_PLANS else ", fused_tiers off and on)"): row(hk[k])
           for n, hk in hgn_kernels.items()},
    }
    sharded_rows = lambda k: {f"sharded step shard, {r['shape']}": row(r)
                              for tag, r in spmd_models_rows.items() if tag.startswith(k + " ")}
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
             shapes={**shapes(k1_shapes), **path_rows("K1"), **sharded_rows("K1 raw")}),
        dict(entry("fused_edge_block_bwd remat (K2)", "fused_block_bwd.cu", "fused_block.py:1008",
                   launches["K2"], bwd[("K2", "bfloat16")]),
             main_kernel_ms=bwd[("K2", "bfloat16")]["main_kernel_ms"],
             shapes={**path_rows("K2"), **sharded_rows("K2")}),
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
             ring_bound_ms=k7[("K7", "bfloat16")]["ring_bound_ms"], gated_ms=k7[("K7", "bfloat16")]["gated_ms"],
             shapes=sharded_rows("K7")),
    ]
    # the sharded step's modes: launches from phase_spmd's main paths only
    spmd_k = lambda tag, k: spmd_timings[tag]["launches"][k]
    kernels += [
        dict(entry("fused_edge_block_fwd raw, sharded step (K1)", "fused_block_fwd.cu", "fused_block.py:393",
                   spmd_k("2x2", "K1"), spmd_rows["K1 raw"]), shape=spmd_rows["K1 raw"]["shape"]),
        dict(entry("fused_edge_block_bwd remat at the global degree, sharded step (K2)", "fused_block_bwd.cu",
                   "fused_block.py:1008", spmd_k("2x2", "K2"), spmd_rows["K2 2x2"]),
             shape=spmd_rows["K2 2x2"]["shape"]),
        dict(entry("fused_edge_block_bwd remat on the overlap layout, sharded step (K2)", "fused_block_bwd.cu",
                   "fused_block.py:1008", spmd_k(f"1x4 overlap {HALO_BANDS}", "K2"),
                   spmd_rows[f"K2 1x4 overlap {HALO_BANDS}"]),
             shape=spmd_rows[f"K2 1x4 overlap {HALO_BANDS}"]["shape"]),
        dict(entry("fused_edge_block_overlap batched, sharded step (K7)", "fused_overlap.cu", "fused_overlap.py:171",
                   spmd_k(f"1x4 overlap {HALO_BANDS}", "K7"), spmd_rows["K7 batched"]),
             shape=spmd_rows["K7 batched"]["shape"]),
        dict(entry("ring_all_reduce_segments on a sub-ring (K6)", "ring.cu", "ring.py:60",
                   spmd_timings["halo 2x2 ring"]["launches"], spmd_rows["K6 sub-ring"]),
             shape=spmd_rows["K6 sub-ring"]["shape"]),
        dict(entry("fused_edge_block_overlap on a sub-ring (K7)", "fused_overlap.cu", "fused_overlap.py:171",
                   spmd_timings["halo 2x2 overlap"]["launches"], spmd_rows["K7 sub-ring"]),
             shape=spmd_rows["K7 sub-ring"]["shape"]),
    ]
    # the sharded step with RMP: launches from phase_spmd_rmp's main paths only
    rmp_k = lambda tag, k: spmd_rmp_timings[tag]["launches"][k]
    kernels += [
        dict(entry("fused_edge_block_fwd raw over N + K rows with masks, sharded RMP step (K1)", "fused_block_fwd.cu",
                   "fused_block.py:393", rmp_k("rmp 2x2", "K1"), spmd_rmp_rows["K1 raw rmp 2x2"]),
             shape=spmd_rmp_rows["K1 raw rmp 2x2"]["shape"]),
        dict(entry("fused_edge_block_bwd remat over N + K rows with masks, sharded RMP step (K2)", "fused_block_bwd.cu",
                   "fused_block.py:1008", rmp_k("rmp 2x2", "K2"), spmd_rmp_rows["K2 rmp 2x2"]),
             shape=spmd_rmp_rows["K2 rmp 2x2"]["shape"]),
        dict(entry("fused_edge_block_bwd remat over N + K rows on the overlap layout, sharded RMP step (K2)",
                   "fused_block_bwd.cu", "fused_block.py:1008", rmp_k(f"rmp 1x4 overlap {HALO_BANDS}", "K2"),
                   spmd_rmp_rows[f"K2 rmp 1x4 overlap {HALO_BANDS}"]),
             shape=spmd_rmp_rows[f"K2 rmp 1x4 overlap {HALO_BANDS}"]["shape"]),
        dict(entry("fused_edge_block_overlap over N + K rows with masks, sharded RMP step (K7)", "fused_overlap.cu",
                   "fused_overlap.py:171", rmp_k(f"rmp 1x4 overlap {HALO_BANDS}", "K7"),
                   spmd_rmp_rows[f"K7 rmp 1x4 overlap {HALO_BANDS}"]),
             shape=spmd_rmp_rows[f"K7 rmp 1x4 overlap {HALO_BANDS}"]["shape"]),
        dict(entry("pna_sorted on a data row's joined shards, sharded RMP step (K4f)", "segment_pna.cu",
                   "segment_pna.py:81", rmp_k("rmp sorted 2x2", "K4f"), spmd_rmp_rows["K4f joined"]),
             shape=spmd_rmp_rows["K4f joined"]["shape"]),
        dict(entry("pna_sorted_bwd on a data row's joined shards, sharded RMP step (K4b)", "segment_pna.cu",
                   "segment_pna.py:183", rmp_k("rmp sorted 2x2", "K4b"), spmd_rmp_rows["K4b joined"]),
             shape=spmd_rmp_rows["K4b joined"]["shape"]),
    ]
    # the sharded step on cylinder, plate and HGN plate: launches from phase_spmd_models' main paths only
    models_k = lambda tag, k: spmd_models_timings[tag]["launches"][k]
    for name, label in (("cylinder", "cylinder"), ("plate", "plate"), ("hgn_plate", "HGN plate")):
        kernels += [
            dict(entry(f"fused_edge_block_fwd raw float32, sharded {label} step (K1)", "fused_block_fwd.cu",
                       "fused_block.py:393", models_k(f"{name} 2x2", "K1"), spmd_models_rows[f"K1 raw {name} 2x2"]),
                 shape=spmd_models_rows[f"K1 raw {name} 2x2"]["shape"]),
            dict(entry(f"fused_edge_block_bwd remat float32 at the global degree, sharded {label} step (K2)",
                       "fused_block_bwd.cu", "fused_block.py:1008", models_k(f"{name} 2x2", "K2"),
                       spmd_models_rows[f"K2 {name} 2x2"]),
                 shape=spmd_models_rows[f"K2 {name} 2x2"]["shape"]),
        ]
    kernels += [
        dict(entry("fused_edge_block_bwd remat float32 on the overlap layout, sharded cylinder step (K2)",
                   "fused_block_bwd.cu", "fused_block.py:1008", models_k("cylinder 1x4 overlap", "K2"),
                   spmd_models_rows["K2 cylinder 1x4 overlap"]),
             shape=spmd_models_rows["K2 cylinder 1x4 overlap"]["shape"]),
        dict(entry("fused_edge_block_overlap batched float32, sharded cylinder step (K7)", "fused_overlap.cu",
                   "fused_overlap.py:171", models_k("cylinder 1x4 overlap", "K7"),
                   spmd_models_rows["K7 cylinder 1x4 overlap"]),
             shape=spmd_models_rows["K7 cylinder 1x4 overlap"]["shape"]),
    ]
    # K2 with the hybrid's tie tolerance: launches from phase_hybrid's main paths only
    kernels += [
        dict(entry(f"fused_edge_block_bwd remat with the tie tolerance {hybrid_rows[name]['tie_tol']:g}, "
                   f"hybrid {label} step (K2)", "fused_block_bwd.cu", "fused_block.py:1008",
                   hybrid_timings[name]["train_launches"]["K2 tie"], hybrid_rows[name]),
             shape=hybrid_rows[name]["shape"], near_ties=hybrid_rows[name]["near_ties"],
             unwon_extrema=hybrid_rows[name]["unwon_extrema"],
             unwon_extrema_tie_tol_0=hybrid_rows[name]["unwon_extrema_exact"])
        for name, label in (("flag", "flag bf16"), ("cylinder", "cylinder float32"))
    ]
    # RMP with HDBSCAN's padded cluster count: launches from phase_cluster's main paths only
    kp_rows = sorted(cluster_rows, key=lambda t: int(t.split("=")[1]))
    kernels += [
        dict(entry(f"{name} over N + Kp rows, HDBSCAN ({k})", src, pallas, cluster_launches[k],
                   cluster_rows[kp_rows[-1]][k]),
             shape=f"bf16 B={TRAIN_FRAMES} E=9282 {kp_rows[-1]}",
             shapes={f"bf16 B={TRAIN_FRAMES} E=9282 {t}": row(cluster_rows[t][k]) for t in kp_rows})
        for name, src, pallas, k in (("fused_edge_block_fwd", "fused_block_fwd.cu", "fused_block.py:393", "K1"),
                                     ("fused_edge_block_bwd remat", "fused_block_bwd.cu", "fused_block.py:1008",
                                      "K2"))
    ]
    # the bucketed task loops: launches from phase_bucketed's main paths only
    kernels += [
        dict(entry(f"{kname} float32 on padded topologies, bucketed task loop ({k})", src, pallas,
                   bucketed_launches[k], bucket_rows["cylinder"][k]),
             shape=f"float32 B={MODEL_FRAMES} rows={bucket_timings['cylinder']['capacity'][0]} "
                   f"E={bucket_timings['cylinder']['capacity'][1]} (cylinder)",
             launches_by_model={n: t["launches"][k] for n, t in bucket_timings.items()})
        for kname, src, pallas, k in (("fused_edge_block_fwd", "fused_block_fwd.cu", "fused_block.py:393", "K1"),
                                      ("fused_edge_block_bwd remat", "fused_block_bwd.cu", "fused_block.py:1008",
                                       "K2"))
    ]
    # the pod steps: launches from the pod's processes' main paths only
    pod_k = lambda run, k: pod_timings["launches_by_run"][run][k]
    kernels += [
        dict(entry("fused_edge_block_fwd raw, pod step in two processes (K1)", "fused_block_fwd.cu",
                   "fused_block.py:393", pod_k("2x2", "K1"), pod_rows["K1 raw"]), shape=pod_rows["K1 raw"]["shape"]),
        dict(entry("fused_edge_block_bwd remat at the global degree, pod step in two processes (K2)",
                   "fused_block_bwd.cu", "fused_block.py:1008", pod_k("2x2", "K2"), pod_rows["K2"]),
             shape=pod_rows["K2"]["shape"]),
        dict(entry("fused_edge_block_fwd raw, pod step with the graph row across two processes (K1)",
                   "fused_block_fwd.cu", "fused_block.py:393", pod_k("1x2 fused", "K1"), pod_rows["K1 raw row"]),
             shape=pod_rows["K1 raw row"]["shape"]),
        dict(entry("fused_edge_block_bwd remat at the global degree, pod step with the graph row across two processes "
                   "(K2)", "fused_block_bwd.cu", "fused_block.py:1008", pod_k("1x2 fused", "K2"), pod_rows["K2 row"]),
             shape=pod_rows["K2 row"]["shape"]),
        dict(entry("pna_sorted on the graph row's shards joined across two processes, pod step (K4f)",
                   "segment_pna.cu", "segment_pna.py:81", pod_k("1x2 sorted", "K4f"), pod_rows["K4f joined row"]),
             shape=pod_rows["K4f joined row"]["shape"]),
        dict(entry("pna_sorted_bwd on the graph row's shards joined across two processes, pod step (K4b)",
                   "segment_pna.cu", "segment_pna.py:183", pod_k("1x2 sorted", "K4b"), pod_rows["K4b joined row"]),
             shape=pod_rows["K4b joined row"]["shape"]),
        dict(entry("ring_all_reduce_segments across two processes on one card, CUDA IPC (K6)", "ring.cu", "ring.py:60",
                   pod_k("1x2 ring", "K6"), pod_rows["K6 across processes"]),
             shape=pod_rows["K6 across processes"]["shape"]),
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
                    "spmd": {"launches": spmd_launches, "timings": spmd_timings, "kernels": spmd_rows},
                    "spmd_rmp": {"launches": spmd_rmp_launches, "timings": spmd_rmp_timings,
                                 "kernels": spmd_rmp_rows},
                    "spmd_models": {"launches": spmd_models_launches, "timings": spmd_models_timings,
                                    "kernels": spmd_models_rows},
                    "spmd_arch": {"launches": spmd_arch_launches, "timings": spmd_arch_timings},
                    "hybrid": {"launches": hybrid_launches, "timings": hybrid_timings, "kernels": hybrid_rows},
                    "serving": serve_timings,
                    "serving_launches": serve_launches,
                    "training": train_timings,
                    "training_launches": train_launches,
                    "task": task_timings,
                    "task_launches": task_launches,
                    "rmp": rmp_timings,
                    "rmp_launches": rmp_launches,
                    "rmp_kernels": rmp_kernels,
                    **{name: {"launches": run[0], "timings": run[1], "kernels": model_kernels[name]}
                       for name, run in model_runs.items()},
                    "bucketed": {"launches": bucketed_launches, "timings": bucket_timings, "kernels": bucket_rows},
                    "hgn_plate": {"launches": hgn_launches, "timings": hgn_timings, "kernels": hgn_kernels},
                    "int8": {"launches": int8_launches, "timings": int8_timings},
                    "cluster": {"launches": cluster_launches, "timings": cluster_timings, "kernels": cluster_rows},
                    "pod": {"launches": pod_launches, "timings": pod_timings, "kernels": pod_rows},
                    "pod_cards": {"launches": pod_cards_launches, "timings": pod_cards_timings},
                    "spmd_cards": {"launches": cards_launches, "timings": cards_timings},
                    "cli_s": cli_timings,
                    "phase_seconds": PHASE_SECONDS,
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
