"""The port's CUDA kernels on the card (marker ``cuda``; skips without a card).

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

K1, K2 and K3 are held against their plain PyTorch versions on the same
inputs (an isolated receiver and a masked tail, receivers whose edges span
several kernel tiles, or exactly tied edges), a small flag MeshGraphNets
predictor and a 2-block training step are held against the same state on
the CPU.

Tolerances: float32 rtol = atol = 1e-5 (summation order).  bf16: e2 within
rtol = 2**-7, atol = 2**-5 and the aggregate within rtol = atol = 2**-5
(both sides round at the same points; an element differs only where a sum
in another order rounds the other way, by one bf16 unit in the last place);
the sum over a receiver's 150 edges within atol = 150 * 2**-5.
Predictor outputs (bf16, 2 blocks) within 5% of the largest |output|.

K2 and K3 against their plain versions, both on K1's forward values (the
plain backward takes K1's e2, a1, a2 for its relu masks and tie compare: a
product summed in another order may move a value within one rounding of 0
across it, or break a tie): each output within rtol + atol * max|want|,
float32 rtol = atol = 1e-4 (summation order); bf16 rtol = atol = 2**-6 (one
bf16 unit in the last place, 2**-7, passed through the LayerNorm and MLP
backward); the column sums by relative L2 norm, 1e-4 and 2**-5.  K2's own
recompute of a1, a2 equals K1's bit for bit, and the routed max/min mass
equals the tie count of K1's output exactly.  A training step (2 blocks,
B = 2) on the card against the CPU: float32 loss rtol 1e-4 and gradients
within relative L2 1e-3; bf16 loss within 2**-5 and gradients within
relative L2 2**-3.

K4f and K4b (``agg_vjp: sorted``) against their plain versions on the same
inputs (a masked tail and an isolated receiver, exactly tied edges): K4f's
max and min exactly equal, sum and mean within rtol = atol = 1e-5 (float32)
or one bf16 unit in the last place (2**-7 relative, 1e-5 absolute): the
plain version sums with atomics on the card, in another order.  K4b equals
its plain version bit for bit on K4f's own output: both take the same
float32 steps, and the compare is exact.  Serving and a training step with
``agg_vjp: sorted`` on the card against the CPU, with the tolerances above.
The "interior" cases mask edges inside receivers' segments, as the graph
balancer removes mesh edges.

K5 (the (max, x) product of the Ricci balancer) equals its plain version
bit for bit (each product one rounded multiply, max exact); SDRF through K5
equals SDRF through the plain version on the card (the same lists); a
balancer predictor on the card against the CPU on the same state and the
same static, within 5% of the largest |acceleration|.

K1's raw mode against its plain version with K1's tolerances.  K6 equals
its plain version bit for bit (the same float32 folds in the same order)
for 2, 3 and 4 ranks, with a late rank and over 100 calls in a row.  K7's
e2 equals K1's on the same shard bit for bit; its aggregate is within 1e-6
(float32: the raw partials summed in another order) or the bf16 aggregate
tolerance of K1 raw + the plain all-reduce + finalize.  The halo forward of
a 2-block bf16 flag over 4 ranks on the card within 5% of the largest
|output| of the CPU's and of the single-device forward.  K1 on a second
card (skips with one).

K1 and K2 on a cluster-tier set planned over its valid prefix (a masked
tail in any receiver order) with K1's and K2's tolerances above; an HGN
plate train step (2 hierarchical blocks, fused tiers off and on) twice bit
for bit and against the CPU: loss rtol 1e-4, gradients within relative L2
1e-3 (1e-2 for the cluster tier, whose few rows carry the cluster means'
float32 rounding).

Int8 serving (``nn/quant.py``): ``dense_int8`` on the card bit for bit with
the CPU on shapes that ``torch._int_mm`` refuses unpadded (few rows, inner
or output widths not multiples of 8); int8 ``one_step`` of a small flag and
of HGN plate on the card against the CPU from one float state, with no K1
launch, within the int8 limits of tests/test_torch_port_int8.py (95% of
the elements within rtol 1e-5, atol 1e-6; all within 1% of the largest
move).

The sharded train step (``parallel.sharding.make_spmd_train_step``) over 4
ranks on the one card, 2 x 2 (K1 raw + the plain all-reduce) and 1 x 4 with
overlap bands (batched K7), K2 backward on both, against the single-device
step on the card from one state and noise: the training step's card-vs-CPU
limits above (float32 loss rtol 1e-4, gradients relative L2 1e-3; bf16
2**-5 and 2**-3); two runs bit for bit; each run under a time limit of its
own, past which the process ends with every thread's traceback, so that a
deadlock fails and does not hang.  The same on RMP ``multiscale`` and
``multi`` (float32).

The hybrid (``fused_fwd: xla``): K2 with the tie tolerance against its
plain version with K2's tolerances above, on drhs from the hybrid's forward
on the card; its routed max/min mass equals the count of K1's e2 within the
tolerance of each extremum; a hybrid training step against the CPU with the
train step's limits.

The pod over ``nccl`` (two or more cards; skips below): two processes of
one card each, a ``1 x 2`` pod whose ``graph`` row spans them, fused and
sorted, bit for bit with the in-process ``RankGroup(1, 2)`` over the same
two cards (the same kernels on the same shards, every fold in global rank
order); the planted control without the other process's cotangents misses
the gradients by more than 1e-2 relative L2.
"""
import numpy as np
import pytest
import torch

from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    agg_cotangent_rhs,
    fused_edge_block,
    fused_edge_block_bwd,
    fused_edge_block_bwd_reference,
    fused_edge_block_bwd_stream,
    fused_edge_block_bwd_stream_reference,
    fused_edge_block_fwd,
    fused_edge_block_reference,
    plan_segments,
)
from hyper_graph_nets_tpu_torch.ops.segment_pna import (
    pna_sorted,
    pna_sorted_bwd,
    pna_sorted_bwd_reference,
    pna_sorted_reference,
    sorted_plan,
)
from hyper_graph_nets_tpu_torch.runtime import configure_numerics
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import (
    BF16_ULP,
    _k1_arrays,
    flag_config,
    grid_edges,
    interior_mask_case,
    long_segment_case,
    masked_edge_case,
    tie_edge_case,
)

TOLS = {
    torch.float32: dict(e2=(1e-5, 1e-5), agg=(1e-5, 1e-5)),
    torch.bfloat16: dict(e2=(BF16_ULP, 4 * BF16_ULP), agg=(4 * BF16_ULP, 4 * BF16_ULP)),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    configure_numerics()


def _case(name, L):
    """(arrays, weights, senders, receivers, mask, N, an isolated receiver)."""
    if name == "masked":
        arrays, weights, snd, rcv, mask, N, _ = masked_edge_case(seed=2, B=3, L=L)
        return arrays, weights, snd, rcv, mask, N, 10
    if name == "ties":
        arrays, weights, snd, rcv, mask, N, _ = tie_edge_case(seed=2, B=3, L=L)
        return arrays, weights, snd, rcv, mask, N, None
    if name == "interior":
        arrays, weights, snd, rcv, mask, N = interior_mask_case(seed=2, B=3, L=L)
        return arrays, weights, snd, rcv, mask, N, 10
    if name in BWD_LAYOUT_CASES:
        return _bwd_layout_case(name, L)
    arrays, weights, snd, rcv, mask, N = long_segment_case(seed=2, B=3, L=L)
    return arrays, weights, snd, rcv, mask, N, 9


# Cases of K2/K3's work layout (two teams a CTA, each walking its work items
# in 32-row half tiles): receiver edge counts, batch size.  ``odd_items``:
# three groups of three 20-edge receivers at B = 1, so one team of the last
# CTA has no item, and the middle receiver of each group straddles its two
# half tiles; ``straddle``: groups of 30 + 4 + 30 edges (and an empty
# receiver), so a 4-edge receiver crosses the half-tile boundary and the
# next runs to the tile's end; ``frame``: one frame of a 10 x 10 grid.
BWD_LAYOUT_CASES = {
    "odd_items": ([20] * 9, 1),
    "straddle": ([30, 4, 30, 0] * 3, 2),
    "frame": (None, 1),
}


def _bwd_layout_case(name, L):
    counts, B = BWD_LAYOUT_CASES[name]
    rng = np.random.default_rng(7)
    if counts is None:
        snd, rcv, N = grid_edges(10, 10)
    else:
        N = len(counts)
        rcv = np.repeat(np.arange(N), counts).astype(np.int32)
        snd = rng.integers(0, N, size=len(rcv)).astype(np.int32)
    mask = (rng.random(len(rcv)) > 0.1).astype(np.float32)
    arrays, weights = _k1_arrays(rng, B, len(rcv), N, L)
    return arrays, weights, snd, rcv, mask, N, None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize("case", ["masked", "long_segments", "interior"])
def test_k1_kernel_matches_plain(dtype, L, case):
    _need_card()
    arrays, weights, snd, rcv, mask, N, isolated = _case(case, L)
    t = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    args = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    before = fused_edge_block.launches
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, *args)
    torch.cuda.synchronize()
    assert fused_edge_block.launches == before + 1
    re2, ragg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, *args)
    (er, ea), (gr, ga) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=er, atol=ea)
    # in bf16 each of a long segment's 150 summands may differ by one
    # rounding of e2, so the sum's atol grows with the count
    L = e2.shape[-1]
    sum_atol = ga * 150 if (case == "long_segments" and dtype == torch.bfloat16) else ga
    torch.testing.assert_close(agg[..., L:], ragg[..., L:], rtol=gr, atol=ga)
    torch.testing.assert_close(agg[..., :L], ragg[..., :L], rtol=gr, atol=sum_atol)
    assert bool((agg[:, isolated] == 0).all())


def _pipeline_case(name):
    """K1 inputs that exercise its tile pipeline: (arrays, weights, senders,
    receivers, mask, N).

    ``frame``: one frame of a 10 x 10 grid (B = 1, a few CTAs with one or
    two tiles each).  ``three_tiles``: B = 2, receiver 4 with 150 edges, so
    its segment spans three tiles and the next tile is in the same work
    item.  ``under_one_tile``: 40 edges, fewer than one tile, B = 3.
    ``next_batch``: two groups and B = 300, so a CTA's next work item lies
    in a later batch element.  ``empty_receivers``: 700 receivers, most
    with no edge (a halo shard's shape), so groups close at GROUP_NODES
    receivers and some hold no edge at all."""
    rng = np.random.default_rng(11)
    if name == "frame":
        snd, rcv, N = grid_edges(10, 10)
        B = 1
    else:
        counts = {
            "three_tiles": [3, 2, 4, 1, 150, 2, 0, 5],
            "under_one_tile": [4] * 10,
            "next_batch": [5] * 20,
            "empty_receivers": [0, 0, 0, 2] * 100 + [0] * 300,
        }[name]
        N = len(counts)
        rcv = np.repeat(np.arange(N), counts).astype(np.int32)
        snd = rng.integers(0, N, size=len(rcv)).astype(np.int32)
        B = {"three_tiles": 2, "under_one_tile": 3, "next_batch": 300, "empty_receivers": 1}[name]
    mask = (rng.random(len(rcv)) > 0.1).astype(np.float32)
    arrays, weights = _k1_arrays(rng, B, len(rcv), N, 128)
    return arrays, weights, snd, rcv, mask, N


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "three_tiles", "under_one_tile", "next_batch", "empty_receivers"])
def test_k1_pipeline_matches_plain(case):
    """K1's two teams and their prefetch of the next tile (within a work
    item, across work items and across batch elements) against its plain
    version, bf16, L = 128."""
    _need_card()
    arrays, weights, snd, rcv, mask, N = _pipeline_case(case)
    t = {k: torch.tensor(v).to(torch.bfloat16).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    args = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    plan = plan_segments(rcv, N, senders=snd).to("cuda")
    if case == "next_batch":
        assert plan.num_groups == 2
    before = fused_edge_block.launches
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, *args, plan=plan)
    torch.cuda.synchronize()
    assert fused_edge_block.launches == before + 1
    re2, ragg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, *args)
    (er, ea), (gr, ga) = TOLS[torch.bfloat16]["e2"], TOLS[torch.bfloat16]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=er, atol=ea)
    L = 128
    sum_atol = ga * 150 if case == "three_tiles" else ga  # see test_k1_kernel_matches_plain
    torch.testing.assert_close(agg[..., L:], ragg[..., L:], rtol=gr, atol=ga)
    torch.testing.assert_close(agg[..., :L], ragg[..., :L], rtol=gr, atol=sum_atol)


@pytest.mark.cuda
def test_predictor_on_card_matches_cpu():
    _need_card()
    config = flag_config("bfloat16")
    traj = add_targets(flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)
    card = Predictor(config)
    cpu = Predictor(config, state=card.state, device="cpu")
    before = fused_edge_block.launches
    got = card.one_step(traj)
    assert fused_edge_block.launches == before + 2  # one per block
    want = cpu.one_step(traj)
    assert np.isfinite(got).all()
    base = 2 * traj["world_pos"] - traj["prev|world_pos"]
    scale = np.abs(want - base).max()
    assert np.abs(got - want).max() <= 0.05 * scale


BWD_TOLS = {torch.float32: (1e-4, 1e-4, 1e-4), torch.bfloat16: (2.0**-6, 2.0**-6, 2.0**-5)}


def _bwd_inputs(case, dtype, L, route_only=False):
    """Card tensors of a case, K1's forward with its streams, and cotangents
    (random, or only g_max = g_min = 1)."""
    arrays, weights, snd, rcv, mask, N, _ = _case(case, L)
    t = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    topo = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    plan = plan_segments(rcv, N, senders=snd).to("cuda")
    fwd = fused_edge_block_fwd(t["e"], t["sp"], t["rp"], w, *topo, plan=plan, save_streams=True)
    B, E, L = t["e"].shape
    gen = torch.Generator().manual_seed(5)
    if route_only:
        de2 = torch.zeros(B, E, L, dtype=dtype, device="cuda")
        dagg = torch.zeros(B, N, 4 * L, device="cuda")
        dagg[..., 2 * L :] = 1.0
    else:
        de2 = (torch.randn(B, E, L, generator=gen) * torch.tensor(mask)[:, None]).to(dtype).cuda()
        dagg = torch.randn(B, N, 4 * L, generator=gen).cuda()
    drhs = agg_cotangent_rhs(fwd[1], dagg, topo[1], topo[2], N)
    return t, w, topo, plan, fwd, de2, drhs


def _assert_bwd_close(got, want, dtype):
    rtol, atol, l2 = BWD_TOLS[dtype]
    for g, w in zip(got[:6], want[:6]):  # de, dh, dz2, dz3, dsp, drp
        torch.testing.assert_close(
            g.float(), w.float(), rtol=rtol, atol=atol * float(w.float().abs().max())
        )
    for k in range(5):  # column sums
        assert float((got[6][k] - want[6][k]).norm()) <= l2 * float(want[6][k].norm()), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize(
    "case", ["masked", "long_segments", "ties", "interior", "odd_items", "straddle", "frame"]
)
def test_k2_k3_kernels_match_plain(dtype, L, case):
    """K2 and K3 against their plain versions: an isolated receiver and a
    masked tail, a receiver of 150 edges whose drp carries across half tiles
    and tiles, exact ties, masks inside segments, an odd number of work
    items (one team idle), receivers straddling a tile's two half tiles, a
    frame at B = 1."""
    _need_card()
    t, w, topo, plan, fwd, de2, drhs = _bwd_inputs(case, dtype, L)
    if case == "odd_items":
        assert plan.num_groups * t["e"].shape[0] == 3
    e2, agg, a1, a2, mu, isg = fwd
    before = (fused_edge_block_bwd.launches, fused_edge_block_bwd_stream.launches)
    k2 = fused_edge_block_bwd(t["e"], t["sp"], t["rp"], w, de2, drhs, *topo, plan=plan)
    k3 = fused_edge_block_bwd_stream(t["e"], a1, a2, mu, isg, w, de2, drhs, *topo, plan=plan)
    torch.cuda.synchronize()
    assert (fused_edge_block_bwd.launches, fused_edge_block_bwd_stream.launches) == (
        before[0] + 1, before[1] + 1
    )
    # K2 recomputes K1's forward bit for bit
    assert torch.equal(k2[4], a1) and torch.equal(k2[5], a2)
    ref2 = fused_edge_block_bwd_reference(
        t["e"], t["sp"], t["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2)
    )
    ref3 = fused_edge_block_bwd_stream_reference(t["e"], a1, a2, mu, isg, w, de2, drhs, *topo, e2=e2)
    _assert_bwd_close(k2[:4] + k2[6:], ref2[:4] + ref2[6:], dtype)
    _assert_bwd_close(k3, ref3, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "long_segments", "ties", "odd_items", "straddle"])
def test_routed_mass_equals_the_tie_count(case):
    """With only g_max = g_min = 1, the column sums of the routed cotangent
    count the edges equal to their receiver's extremum in K1's output; every
    receiver with valid edges routes at least once per part and column."""
    _need_card()
    t, w, topo, plan, fwd, de2, drhs = _bwd_inputs(case, torch.bfloat16, 128, route_only=True)
    e2, agg, a1, a2, mu, isg = fwd
    L = e2.shape[-1]
    r = topo[1].long()
    valid = topo[2] > 0
    want = sum(
        ((e2.float() == agg[:, r, k * L : (k + 1) * L]) & valid[None, :, None]).float().sum(dim=(0, 1))
        for k in (2, 3)
    )
    receivers = e2.shape[0] * int(torch.unique(r[valid]).numel())
    assert bool((want >= 2 * receivers).all())
    k2 = fused_edge_block_bwd(t["e"], t["sp"], t["rp"], w, de2, drhs, *topo, plan=plan)
    k3 = fused_edge_block_bwd_stream(t["e"], a1, a2, mu, isg, w, de2, drhs, *topo, plan=plan)
    assert torch.equal(k2[-1][4], want) and torch.equal(k3[-1][4], want)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["remat", "stream"])
def test_fused_edge_block_under_grad_runs_k1_and_its_backward(bwd):
    """On a CUDA tensor under grad: K1 forward, K2 or K3 backward, an output
    that keeps the autograd graph."""
    _need_card()
    arrays, weights, snd, rcv, mask, N, _ = _case("masked", 128)
    t = {k: torch.tensor(v).cuda().requires_grad_() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda().requires_grad_() for k, v in weights.items()}
    args = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    counts = lambda: (fused_edge_block.launches, fused_edge_block_bwd.launches, fused_edge_block_bwd_stream.launches)
    before = counts()
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, *args, bwd=bwd)
    assert e2.grad_fn is not None and agg.grad_fn is not None
    (agg.sum() + e2.sum()).backward()
    torch.cuda.synchronize()
    k2, k3 = (1, 0) if bwd == "remat" else (0, 1)
    assert counts() == (before[0] + 1, before[1] + k2, before[2] + k3)
    assert all(x.grad is not None for x in [*t.values(), *w.values()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bwd", ["remat", "stream", "sorted"])
def test_train_step_on_card_matches_cpu(dtype, bwd):
    _need_card()
    agg_vjp = "sorted" if bwd == "sorted" else "fused"
    config = flag_config(None if dtype == "float32" else dtype, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9)
    if agg_vjp == "fused":
        config["params"]["model"]["fused_bwd"] = bwd
    traj = add_targets(flag_trajectory(num_steps=4, nx=10, ny=10), "world_pos", True)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(1))
    normal = torch.randn(traj["world_pos"].shape, generator=torch.Generator().manual_seed(2))
    results = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(model, config, device=device)
        tstate = trainer.init_train_state(state=state)
        topo = model.topology_from_trajectory(traj, device=device)
        bwd_count = lambda: (
            fused_edge_block_bwd.launches + fused_edge_block_bwd_stream.launches + pna_sorted_bwd.launches
        )
        before = bwd_count()
        loss, _ = trainer.loss_and_grads(tstate, topo, trainer.frames(traj), normal=normal.to(device))
        launched = bwd_count() - before
        assert launched == (2 if device == "cuda" else 0)  # one per block
        grads = {n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()}
        results[device] = (float(loss), grads)
    (lc, gc), (lh, gh) = results["cuda"], results["cpu"]
    loss_tol, grad_tol = (1e-4, 1e-3) if dtype == "float32" else (2.0**-5, 2.0**-3)
    assert abs(lc - lh) <= loss_tol * abs(lh)
    for name, g in gh.items():
        assert float((gc[name] - g).norm()) <= grad_tol * float(g.norm()), name


@pytest.mark.cuda
@pytest.mark.parametrize("agg_vjp", ["fused", "sorted"])
def test_bucketed_train_step_on_card_matches_cpu(agg_vjp):
    """A train step (float32, 2 blocks, B = 2) on the 8x8 flag padded to the
    capacity of a bucket with a 10x9 flag (64 of 90 rows, a masked edge
    tail ending at the top receiver) on the card against the CPU, with the
    float32 limits of the step above: 2 K1 + 2 K2 (fused) or 2 K4f + 2 K4b
    (sorted); the padded rows of a 2-step rollout stay 0 on both."""
    from hyper_graph_nets_tpu_torch.data import bucketing

    _need_card()
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9)
    small = add_targets(flag_trajectory(num_steps=4, nx=8, ny=8), "world_pos", True)
    big = add_targets(flag_trajectory(num_steps=4, nx=10, ny=9, seed=1), "world_pos", True)
    N, E = bucketing.trajectory_capacity([small, big])
    traj = bucketing.pad_trajectory(small, N)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(1))
    normal = torch.randn(traj["world_pos"].shape, generator=torch.Generator().manual_seed(2))
    fwd, bwd = (fused_edge_block, fused_edge_block_bwd) if agg_vjp == "fused" else (pna_sorted, pna_sorted_bwd)
    results = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(model, config, device=device)
        tstate = trainer.init_train_state(state=state)
        topo = bucketing.pad_topology(model, traj, N, E, device=device)
        assert topo.plan is not None and float(topo.mask.sum()) < E
        before = (fwd.launches, bwd.launches)
        loss, _ = trainer.loss_and_grads(tstate, topo, trainer.frames(traj), normal=normal.to(device))
        assert (fwd.launches - before[0], bwd.launches - before[1]) == ((2, 2) if device == "cuda" else (0, 0))
        grads = {n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()}
        with torch.no_grad():
            ops, _ = model.rollout(tstate.model, topo, traj, num_steps=2)
        assert not ops["pred_pos"][:, 64:].any()
        results[device] = (float(loss), grads)
    (lc, gc), (lh, gh) = results["cuda"], results["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for name, g in gh.items():
        assert float((gc[name] - g).norm()) <= 1e-3 * float(g.norm()), name


# -- K4f and K4b (agg_vjp: sorted) -------------------------------------------


def _sorted_inputs(case, dtype, L, B=3):
    """Card tensors of a case for K4f/K4b: (data, receivers, mask, N, plan,
    positions of tied copies)."""
    if case == "masked":
        arrays, _, snd, rcv, mask, N, _ = masked_edge_case(seed=3, B=B, L=L)
        copies = None
    elif case == "interior":
        arrays, _, snd, rcv, mask, N = interior_mask_case(seed=3, B=B, L=L)
        copies = None
    else:
        arrays, _, snd, rcv, mask, N, copies = tie_edge_case(seed=3, B=B, L=L)
    data = torch.tensor(arrays["e"]).to(dtype).cuda()
    plan = sorted_plan(rcv, N, mask).to("cuda")
    return data, torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N, plan, copies


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize("case", ["masked", "ties", "interior"])
def test_k4f_k4b_kernels_match_plain(dtype, L, case):
    _need_card()
    data, rcv, mask, N, plan, copies = _sorted_inputs(case, dtype, L)
    before = (pna_sorted.launches, pna_sorted_bwd.launches)
    out = pna_sorted(data, rcv, mask, N, plan=plan)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(dtype).cuda()
    ge = pna_sorted_bwd(g, out, data, rcv, mask, N, plan=plan)
    torch.cuda.synchronize()
    assert (pna_sorted.launches, pna_sorted_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = pna_sorted_reference(data, rcv, mask, N)
    rtol = 1e-5 if dtype == torch.float32 else BF16_ULP
    torch.testing.assert_close(out[..., : 2 * L].float(), want[..., : 2 * L].float(), rtol=rtol, atol=1e-5)
    assert torch.equal(out[..., 2 * L :], want[..., 2 * L :])
    assert torch.equal(ge, pna_sorted_bwd_reference(g, out, data, rcv, mask, N))
    if case in ("masked", "interior"):
        assert bool((out[:, 10] == 0).all())
        assert bool((ge[:, mask == 0] == 0).all())
    else:
        c = torch.as_tensor(copies).cuda()
        assert torch.equal(ge[:, c], ge[:, c - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "ties", "interior"])
def test_k4b_routed_mass_equals_the_tie_count(case):
    """With only g_max = g_min = 1, the edge cotangents' column sums count
    the edges equal to their receiver's extremum in K4f's output, exactly."""
    _need_card()
    data, rcv, mask, N, plan, _ = _sorted_inputs(case, torch.bfloat16, 128)
    L = data.shape[-1]
    out = pna_sorted(data, rcv, mask, N, plan=plan)
    g = torch.zeros_like(out)
    g[..., 2 * L :] = 1.0
    ge = pna_sorted_bwd(g, out, data, rcv, mask, N, plan=plan)
    r, valid = rcv.long(), mask > 0
    want = sum(
        ((data.float() == out.float()[:, r, k * L : (k + 1) * L]) & valid[None, :, None]).float().sum(dim=(0, 1))
        for k in (2, 3)
    )
    assert torch.equal(ge.float().sum(dim=(0, 1)), want)
    assert bool((want >= 2 * data.shape[0] * int(torch.unique(r[valid]).numel())).all())


@pytest.mark.cuda
def test_pna_sorted_under_grad_runs_k4f_and_k4b():
    _need_card()
    data, rcv, mask, N, plan, _ = _sorted_inputs("masked", torch.bfloat16, 128)
    x = data.clone().requires_grad_()
    before = (pna_sorted.launches, pna_sorted_bwd.launches)
    out = pna_sorted(x, rcv, mask, N, plan=plan)
    assert out.grad_fn is not None
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (pna_sorted.launches, pna_sorted_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert x.grad is not None and bool((x.grad[:, mask == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "ties", "interior"])
def test_pna_sorted_sharded_runs_k4f_and_k4b_once_per_data_row_on_the_joined_shards(case):
    """On a 2 x 2 group on one card, each data row's two shards of a case's
    edges (padded to an even count, the padding masked) run one K4f on the
    joined edges, equal on every rank to K4f on the whole set bit for bit,
    and under autograd one K4b, whose slices are each shard's cotangent: K4b
    on the whole set from the ranks' cotangents summed in rank order."""
    from hyper_graph_nets_tpu_torch.ops.segment_pna import pna_sorted_sharded
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import EdgeLayout

    _need_card()
    data, rcv, mask, N, _, _ = _sorted_inputs(case, torch.bfloat16, 128, B=2)
    layout = EdgeLayout.build(int(rcv.shape[0]), 2)
    data, rcv, mask = layout.relay(data, 0.0, axis=1), layout.relay(rcv, N - 1), layout.relay(mask, 0.0)
    plan = sorted_plan(rcv.cpu().numpy(), N, mask.cpu().numpy()).to("cuda")
    group = RankGroup(2, 2, devices=["cuda:0"] * 4)
    rows = [data, (data.float() * 0.5).to(torch.bfloat16)]  # each data row's frames
    shard = lambda t, k: t.narrow(t.dim() - 2 if t.dim() == 3 else 0, k * layout.per, layout.per).contiguous()
    xs = [shard(rows[group.axis_index(r, "data")], group.axis_index(r, "graph")).requires_grad_()
          for r in range(group.n)]
    before = (pna_sorted.launches, pna_sorted_bwd.launches)
    outs = group.run(lambda r: pna_sorted_sharded(xs[r], shard(rcv, group.axis_index(r, "graph")),
                                                  shard(mask, group.axis_index(r, "graph")), N, plan, group))
    gen = torch.Generator().manual_seed(6)
    gs = [torch.randn(outs[0].shape, generator=gen).to(torch.bfloat16).cuda() for _ in range(group.n)]
    torch.autograd.backward(outs, gs)
    torch.cuda.synchronize()
    assert (pna_sorted.launches, pna_sorted_bwd.launches) == (before[0] + 2, before[1] + 2)
    for d in range(2):
        ranks = [group.rank_at(d, g) for g in range(2)]
        want = pna_sorted(rows[d], rcv, mask, N, plan=plan)
        g = (gs[ranks[0]].float() + gs[ranks[1]].float()).to(torch.bfloat16)
        want_ge = pna_sorted_bwd(g, want, rows[d], rcv, mask, N, plan=plan)
        for k, r in enumerate(ranks):
            assert torch.equal(outs[r].detach(), want)
            assert torch.equal(xs[r].grad, shard(want_ge, k))


@pytest.mark.cuda
def test_sorted_predictor_on_card_matches_cpu():
    _need_card()
    config = flag_config("bfloat16", agg_vjp="sorted")
    traj = add_targets(flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)
    card = Predictor(config)
    cpu = Predictor(config, state=card.state, device="cpu")
    before = (fused_edge_block.launches, pna_sorted.launches)
    got = card.one_step(traj)
    assert (fused_edge_block.launches, pna_sorted.launches) == (before[0], before[1] + 2)
    want = cpu.one_step(traj)
    assert np.isfinite(got).all()
    base = 2 * traj["world_pos"] - traj["prev|world_pos"]
    scale = np.abs(want - base).max()
    assert np.abs(got - want).max() <= 0.05 * scale


# -- K5 and the Ricci balancer -------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(1600, 1600, 1600), (1000, 1300, 700), (37, 5, 129), (64, 0, 3), (1, 1, 1), (129, 257, 131)],
)
def test_k5_matches_plain_bit_for_bit(shape):
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference

    N, K, M = shape
    gen = torch.Generator().manual_seed(7)
    x = (torch.rand(N, K, generator=gen) * (torch.rand(N, K, generator=gen) > 0.5)).cuda()
    y = (torch.rand(K, M, generator=gen) * (torch.rand(K, M, generator=gen) > 0.5)).cuda()
    before = maxprod.launches
    got = maxprod(x, y)
    torch.cuda.synchronize()
    assert maxprod.launches == before + 1 and got.shape == (N, M)
    want = maxprod_reference(x, y) if K else torch.zeros(N, M, device="cuda")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1600, 1600, 1600), (65, 33, 70)])
def test_k5_of_zeros_is_zero(shape):
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference

    N, K, M = shape
    x, y = torch.zeros(N, K, device="cuda"), torch.zeros(K, M, device="cuda")
    got = maxprod(x, y)
    assert torch.equal(got, maxprod_reference(x, y)) and not bool(got.any())


@pytest.mark.cuda
def test_k5_on_the_flag_curvature_operands():
    """``B = relu(A @ A - A)`` and ``A`` of the 40 x 40 flag, both orders."""
    _need_card()
    from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
    from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference

    edges = cells_to_edges(_grid_triangulation(40, 40))
    A = torch.zeros(1600, 1600, device="cuda")
    A[torch.tensor(edges.senders).long(), torch.tensor(edges.receivers).long()] = 1.0
    B = torch.clamp(A @ A - A, min=0.0)
    for x, y in ((B, A), (A, B)):
        assert torch.equal(maxprod(x, y), maxprod_reference(x, y))


@pytest.mark.cuda
def test_sdrf_through_k5_equals_sdrf_through_the_plain_version():
    _need_card()
    from hyper_graph_nets_tpu_torch.balancer.ricci import sdrf
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference
    from torch_port_cases import grid_edges

    snd, rcv, N = grid_edges(12, 12)
    before = maxprod.launches
    got = sdrf(snd, rcv, N, loops=20, remove_edges=True, tau=150, device="cuda")
    assert maxprod.launches == before + 2 * sdrf.loops_run
    assert got == sdrf(snd, rcv, N, loops=20, remove_edges=True, tau=150, device="cuda", maxprod_fn=maxprod_reference)
    assert got == sdrf(snd, rcv, N, loops=20, remove_edges=True, tau=150)  # on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("agg_vjp", ["fused", "sorted"])
def test_balancer_predictor_on_card_matches_cpu(agg_vjp):
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod

    config = flag_config("bfloat16", agg_vjp=agg_vjp)
    config["params"]["model"]["graph_balancer"] = {
        "algorithm": "ricci", "remove_edges": True, "ricci": {"loops": 10, "tau": 150},
    }
    traj = add_targets(flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)
    card = Predictor(config)
    cpu = Predictor(config, state=card.state, device="cpu")
    before = maxprod.launches
    got = card.one_step(traj)
    assert maxprod.launches > before
    static = card.expansion.static
    assert bool((static[0].mesh_keep == 0).any())  # SDRF removed mesh edges
    want = cpu.one_step(traj, static=static)
    assert np.isfinite(got).all()
    base = 2 * traj["world_pos"] - traj["prev|world_pos"]
    scale = np.abs(want - base).max()
    assert np.abs(got - want).max() <= 0.05 * scale


# -- the halo forward's kernels: K1 raw, K6, K7 ------------------------------
#
# K1 raw against its plain version with K1's tolerances.  K6 against its
# plain version bit for bit (the same float32 folds in the same order), for
# 2, 3 and 4 ranks on the card(s) there are, with one rank's launch delayed
# and over many calls in a row.  K7's e2 equals K1's on the same shard bit
# for bit, its aggregate K1 raw + the plain all-reduce + finalize within
# 1e-6 (float32; the raw partials' float32 sums in another order) or the
# bf16 aggregate tolerance above.


def _ring_payload(n, R, C, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(R, C, generator=gen) for _ in range(n)]


def _pna_segments(N):
    return [(0, N, "sum"), (N, 2 * N, "sum"), (2 * N, 3 * N, "max"), (3 * N, 4 * N, "min")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k1_raw_kernel_matches_plain(dtype):
    _need_card()
    arrays, weights, snd, rcv, mask, N, isolated = _case("masked", 128)
    t = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    args = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    e2, raw = fused_edge_block_fwd(t["e"], t["sp"], t["rp"], w, *args, raw=True)
    torch.cuda.synchronize()
    re2, rraw = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, *args, raw=True)
    (er, ea), (gr, ga) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=er, atol=ea)
    torch.testing.assert_close(raw, rraw, rtol=gr, atol=ga)
    L = 128
    assert bool((raw[:, isolated, : 2 * L] == 0).all())
    assert bool((raw[:, isolated, 2 * L : 3 * L] == -1e30).all())
    assert bool((raw[:, isolated, 3 * L :] == 1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("shape", [(4 * 1600, 128), (4 * 251, 37)], ids=["main", "odd"])
def test_k6_matches_plain_bit_for_bit(n, shape):
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.ring import (
        ring_all_reduce_segments,
        ring_all_reduce_segments_reference,
    )
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    group = RankGroup(n)
    xs = [x.to(group.device(r)) for r, x in enumerate(_ring_payload(n, *shape))]
    segments = _pna_segments(shape[0] // 4)
    torch.cuda.synchronize()
    before = ring_all_reduce_segments.launches
    got = ring_all_reduce_segments(xs, segments, group)
    group.check()
    assert ring_all_reduce_segments.launches == before + n
    want = ring_all_reduce_segments_reference(xs, segments)
    for r in range(n):
        assert torch.equal(got[r], want[r]), f"rank {r}"


@pytest.mark.cuda
def test_k6_with_a_delayed_rank_and_many_calls():
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.ring import (
        ring_all_reduce_segments,
        ring_all_reduce_segments_reference,
    )
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    n, N = 4, 1600
    group = RankGroup(n)
    segments = _pna_segments(N)
    for call in range(100):
        xs = [x.to(group.device(r)) for r, x in enumerate(_ring_payload(n, 4 * N, 128, seed=call))]
        torch.cuda.synchronize()
        if call % 10 == 0:  # rank 1 starts about 1 ms late
            with torch.cuda.device(group.device(1)), torch.cuda.stream(group.stream(1)):
                torch.cuda._sleep(2_000_000)
        got = ring_all_reduce_segments(xs, segments, group)
        if call % 10 == 9:
            group.check()
            want = ring_all_reduce_segments_reference(xs, segments)
            for r in range(n):
                assert torch.equal(got[r], want[r]), f"call {call} rank {r}"
    group.check()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize(
    "shape", [(2050, 132), (40000, 128), (333, 7)], ids=["uneven_chunks", "two_windows", "odd_numel"]
)
def test_k6_on_uneven_chunks_windows_and_odd_payloads(n, shape):
    """K6 bit for bit where a sub-ring's floats do not split evenly into
    chunks, where a sub-ring needs more than one window of shared memory,
    and on a payload whose float count is not a multiple of 4 (padded)."""
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.ring import (
        ring_all_reduce_segments,
        ring_all_reduce_segments_reference,
    )
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    group = RankGroup(n)
    R = shape[0]
    segments = [(0, R // 3, "max"), (R // 3, R // 2, "sum"), (R // 2 + 5, R, "min")]  # a gap keeps x_r
    for call in range(3):
        xs = [x.to(group.device(r)) for r, x in enumerate(_ring_payload(n, *shape, seed=call))]
        torch.cuda.synchronize()
        got = ring_all_reduce_segments(xs, segments, group)
        group.check()
        want = ring_all_reduce_segments_reference(xs, segments)
        for r in range(n):
            assert got[r].shape == shape and torch.equal(got[r], want[r]), f"call {call} rank {r}"


_LATE_RANK = """
import sys
import torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
group = RankGroup(2, devices=["cuda:0", "cuda:0"])
if {kernel!r} == "K6":
    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments
    xs = [torch.randn(64, 128, device="cuda:0") for _ in range(2)]
    run = lambda: ring_all_reduce_segments(xs, [(0, 64, "sum")], group)
else:
    from test_torch_port_cuda import _on, _tail_shards
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    shards, N = _tail_shards(2, torch.bfloat16, (0, 23))
    shards = [dict(_on(x, "cuda:0"), plan=x["plan"].to("cuda:0")) for x in shards]
    run = lambda: fused_edge_block_overlap(shards, N, group, bands=4)
run()  # every buffer, the ring state and the error word exist before the late call
group.check()
with torch.cuda.stream(group.stream(1)):
    torch.cuda._sleep(8_000_000_000)  # rank 1 starts seconds late: past the 2 s spin limit
run()
try:
    group.check()
except RuntimeError as exc:
    print(exc)
    sys.exit(3)
sys.exit(0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_a_rank_without_its_neighbour_fails_through_the_error_word(kernel):
    """A rank whose neighbour's kernel starts past the spin limit traps after
    writing the error word, and ``group.check`` raises on it (in a process
    of its own: the trap ends the card's context), instead of hanging."""
    _need_card()
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    code = _LATE_RANK.format(root=os.path.dirname(tests), tests=tests, kernel=kernel)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "waited past its time limit" in proc.stdout, proc.stdout


def _tail_shards(n, dtype, tails, L=128, nx=10, seed=0):
    """An nx x nx grid's edges split contiguously over n ranks, rank r's
    shard followed by tails[r] masked padding edges at receiver N-1 (a tail
    of None: the shard is only its padding, 100 edges), with K1 inputs and
    K7's plans; (shards, N)."""
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import overlap_plan
    from torch_port_cases import grid_edges

    snd, rcv, N = grid_edges(nx, nx)
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, len(snd), n + 1).astype(int)
    sp = torch.tensor(rng.normal(size=(N, L)).astype(np.float32)).to(dtype)
    rp = torch.tensor(rng.normal(size=(N, L)).astype(np.float32)).to(dtype)
    weights = {k: torch.tensor(0.1 * rng.normal(size=(L, L)).astype(np.float32)) for k in ("we", "w2", "w3")}
    weights.update({k: torch.tensor(0.1 * rng.normal(size=L).astype(np.float32)) for k in ("b1", "b2", "b3", "lnb")})
    weights["lns"] = torch.tensor(1 + 0.1 * rng.normal(size=L).astype(np.float32))
    shards = []
    for r in range(n):
        s, c = snd[bounds[r] : bounds[r + 1]], rcv[bounds[r] : bounds[r + 1]]
        tail = tails[r]
        if tail is None:
            s, c, tail = s[:0], c[:0], 100
        s = np.concatenate([s, np.zeros(tail, s.dtype)])
        c = np.concatenate([c, np.full(tail, N - 1, c.dtype)])
        m = (np.arange(len(s)) < len(s) - tail).astype(np.float32)
        shards.append(dict(
            e=torch.tensor(rng.normal(size=(len(s), L)).astype(np.float32)).to(dtype),
            sp=sp, rp=rp, weights=weights, senders=torch.tensor(s), receivers=torch.tensor(c),
            mask=torch.tensor(m), plan=overlap_plan(c, m, N, 4, senders=s),
        ))
    return shards, N


def _check_k7(shards, N, group, dtype):
    """K7 on the shards: e2 equal to K1 raw's on each shard bit for bit,
    agg within the tolerance of K1 raw + the plain all-reduce + finalize."""
    from hyper_graph_nets_tpu_torch.core.segment_ops import finalize_partials
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap

    torch.cuda.synchronize()
    got = fused_edge_block_overlap(shards, N, group, bands=4)
    group.check()
    raws = []
    for r, x in enumerate(shards):
        e2, raw = fused_edge_block_fwd(
            x["e"][None], x["sp"][None], x["rp"][None], x["weights"], x["senders"], x["receivers"],
            x["mask"], N, x.get("plan"), raw=True,
        )
        assert torch.equal(got[r][0], e2[0]), f"rank {r} e2"
        raws.append(raw[0].to(group.device(0)))
    L = shards[0]["e"].shape[-1]
    total = torch.cat([
        sum(raws[1:], raws[0])[:, : 2 * L],
        torch.stack([x[:, 2 * L : 3 * L] for x in raws]).amax(0),
        torch.stack([x[:, 3 * L :] for x in raws]).amin(0),
    ], dim=-1)
    want = finalize_partials(total)
    tol = 1e-6 if dtype == torch.float32 else TOLS[dtype]["agg"][0]
    for r in range(len(shards)):
        torch.testing.assert_close(got[r][1].to(want.device), want, rtol=tol, atol=tol)


def _on(x, device):
    move = lambda v: v.to(device) if torch.is_tensor(v) else v
    return {k: ({a: b.to(device) for a, b in v.items()} if isinstance(v, dict) else move(v)) for k, v in x.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize(
    "tails", [(0, 23, 150, 64), (0, 0, 0, None), (None, 5, None, 129)],
    ids=["tails", "one_all_tail", "two_all_tail"],
)
def test_k7_on_padded_tails_and_all_tail_shards(tails, dtype):
    """K7 where ranks' shards end in no tail, a tail shorter than a tile,
    one over two tiles, or are nothing but padding: the tail is e2-only work
    that no band waits for."""
    _need_card()
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    group = RankGroup(len(tails))
    shards, N = _tail_shards(len(tails), dtype, tails)
    shards = [_on(x, group.device(r)) for r, x in enumerate(shards)]
    for x in shards:
        x["plan"] = x["plan"].to(x["e"].device)
    _check_k7(shards, N, group, dtype)


@pytest.mark.cuda
def test_k7_with_a_delayed_rank_and_many_calls():
    """K7 100 calls in a row without a host synchronization, one rank's
    launch delayed every tenth call, each call's outputs held."""
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    n = 4
    group = RankGroup(n)
    shards, N = _tail_shards(n, torch.bfloat16, (0, 23, 150, 64))
    shards = [_on(x, group.device(r)) for r, x in enumerate(shards)]
    for x in shards:
        x["plan"] = x["plan"].to(x["e"].device)
    _check_k7(shards, N, group, torch.bfloat16)
    first = [tuple(t.clone() for t in out) for out in fused_edge_block_overlap(shards, N, group, bands=4)]
    group.check()
    outs = []
    for call in range(100):
        if call % 10 == 0:  # rank 1 starts about 1 ms late
            with torch.cuda.device(group.device(1)), torch.cuda.stream(group.stream(1)):
                torch.cuda._sleep(2_000_000)
        outs.append(fused_edge_block_overlap(shards, N, group, bands=4))
    group.check()
    for call, out in enumerate(outs):
        for r in range(n):
            assert torch.equal(out[r][0], first[r][0]) and torch.equal(out[r][1], first[r][1]), f"call {call} rank {r}"


def _overlap_shards(n, dtype, L=128, nx=20, chunk=64, seed=0):
    """One frame's edge shards of an nx x nx grid, dealt round-robin by
    chunk over n ranks, with K1 inputs; (shards, N)."""
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import chunk_roundrobin_permutation
    from hyper_graph_nets_tpu_torch.parallel.sharding import pad_to_multiple
    from torch_port_cases import grid_edges

    snd, rcv, N = grid_edges(nx, nx)
    E = len(snd)
    snd = pad_to_multiple(snd, chunk * n, 0)
    rcv = pad_to_multiple(rcv, chunk * n, N - 1)
    mask = np.zeros(len(snd), np.float32)
    mask[:E] = 1.0
    perm = chunk_roundrobin_permutation(len(snd), n, chunk)
    snd, rcv, mask = snd[perm], rcv[perm], mask[perm]
    rng = np.random.default_rng(seed)
    per = len(snd) // n
    sp = torch.tensor(rng.normal(size=(N, L)).astype(np.float32)).to(dtype)
    rp = torch.tensor(rng.normal(size=(N, L)).astype(np.float32)).to(dtype)
    weights = {k: torch.tensor(0.1 * rng.normal(size=(L, L)).astype(np.float32)) for k in ("we", "w2", "w3")}
    weights.update({k: torch.tensor(0.1 * rng.normal(size=L).astype(np.float32)) for k in ("b1", "b2", "b3", "lnb")})
    weights["lns"] = torch.tensor(1 + 0.1 * rng.normal(size=L).astype(np.float32))
    shards = []
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        shards.append(dict(
            e=torch.tensor(rng.normal(size=(per, L)).astype(np.float32)).to(dtype),
            sp=sp, rp=rp, weights=weights,
            senders=torch.tensor(snd[sl]), receivers=torch.tensor(rcv[sl]), mask=torch.tensor(mask[sl]),
        ))
    return shards, N


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k7_matches_k1_raw_and_the_all_reduce(n, dtype):
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.fused_block import plan_segments
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.core.segment_ops import finalize_partials

    group = RankGroup(n)
    shards, N = _overlap_shards(n, dtype)
    on = lambda x, d: {k: (v.to(d) if torch.is_tensor(v) else {a: b.to(d) for a, b in v.items()}) for k, v in x.items()}
    shards = [on(x, group.device(r)) for r, x in enumerate(shards)]
    for x in shards:
        x["plan"] = plan_segments(x["receivers"], N, senders=x["senders"]).to(x["e"].device)
    torch.cuda.synchronize()
    got = fused_edge_block_overlap(shards, N, group, bands=4)
    group.check()
    raws = []
    for r, x in enumerate(shards):
        e2, raw = fused_edge_block_fwd(
            x["e"][None], x["sp"][None], x["rp"][None], x["weights"], x["senders"], x["receivers"],
            x["mask"], N, x["plan"], raw=True,
        )
        assert torch.equal(got[r][0], e2[0]), f"rank {r} e2"
        raws.append(raw[0].to(group.device(0)))
    L = 128
    total = torch.cat([
        sum(raws[1:], raws[0])[:, : 2 * L],
        torch.stack([x[:, 2 * L : 3 * L] for x in raws]).amax(0),
        torch.stack([x[:, 3 * L :] for x in raws]).amin(0),
    ], dim=-1)
    want = finalize_partials(total)
    tol = 1e-6 if dtype == torch.float32 else TOLS[dtype]["agg"][0]
    for r in range(n):
        torch.testing.assert_close(got[r][1].to(want.device), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_k1_launches_on_a_second_card():
    """The kernels' shared-memory attribute is per device: K1 on cuda:1
    after cuda:0."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    arrays, weights, snd, rcv, mask, N, _ = _case("masked", 128)
    outs = []
    for dev in ("cuda:0", "cuda:1"):
        t = {k: torch.tensor(v).to(torch.bfloat16).to(dev) for k, v in arrays.items()}
        w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).to(dev) for k, v in weights.items()}
        args = (torch.tensor(snd).to(dev), torch.tensor(rcv).to(dev), torch.tensor(mask).to(dev), N)
        outs.append(fused_edge_block(t["e"], t["sp"], t["rp"], w, *args))
        torch.cuda.synchronize(dev)
    assert torch.equal(outs[0][0].cpu(), outs[1][0].cpu())
    assert torch.equal(outs[0][1].cpu(), outs[1][1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "ring", "overlap"])
def test_halo_forward_on_card_matches_cpu(path):
    """The halo forward of a 2-block bf16 flag over 4 ranks on the card
    against the same ranks on the CPU and the single-device forward, within
    5% of the largest |output|; 2 K6 or K7 launches per rank."""
    _need_card()
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph
    from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology

    config = flag_config("bfloat16", agg_vjp="xla" if path == "ring" else "fused")
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(0))
    traj = add_targets(flag_trajectory(num_steps=4, nx=10, ny=10), "world_pos", True)
    outs = {}
    for where in ("cuda", "cpu"):
        group = RankGroup(4, device=None if where == "cuda" else "cpu")
        st = state.to(group.device(0))
        topo = model.topology_from_trajectory(traj, device=group.device(0))
        stopo = shard_topology(topo, group, overlap_bands=4 if path == "overlap" else None, chunk=32)
        frame = {k: torch.as_tensor(v[0], device=group.device(0)) for k, v in traj.items() if k != "cells"}
        with torch.no_grad():
            graph, _, _ = model.make_graph(st, stopo, frame, False)
        fwd = make_halo_forward(model, group, ring=path == "ring", overlap=path == "overlap")
        before = (ring_all_reduce_segments.launches, fused_edge_block_overlap.launches)
        outs[where] = [o.cpu() for o in fwd(st, split_graph(graph, group), all_ranks=True)]
        after = (ring_all_reduce_segments.launches, fused_edge_block_overlap.launches)
        want = {"fused": (0, 0), "ring": (8, 0), "overlap": (0, 8)}[path] if where == "cuda" else (0, 0)
        assert (after[0] - before[0], after[1] - before[1]) == want
        if where == "cpu":
            with torch.no_grad():
                g1, _, _ = model.make_graph(st, topo, frame, False)
                single = model.forward(st, g1)
    scale = float(single.abs().max())
    for r in range(4):
        assert torch.isfinite(outs["cuda"][r]).all()
        assert float((outs["cuda"][r] - outs["cpu"][r]).abs().max()) <= 0.05 * scale
        assert float((outs["cuda"][r] - single).abs().max()) <= 0.05 * scale


# -- remote message passing ----------------------------------------------------


def _rmp_config(dtype=None, balancer=False):
    config = flag_config(dtype, agg_vjp="fused")
    model = config["params"]["model"]
    model.update(noise=0.003, gamma=0.9)
    model["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": 4, "hyper_noise": 0.005}
    if balancer:
        model["rmp"] = {"clustering": "none", "connector": "none"}
        model["graph_balancer"] = {"algorithm": "ricci", "remove_edges": True, "ricci": {"loops": 8, "tau": 150}}
    return config


def _check_k1_k2_over_rows(snd, rcv, N, rows, plan, dtype, seed=5):
    """K1 and K2 with ``plan`` over ``rows`` node rows (rows N.. receive no
    edge) against their plain versions, K1's tolerances and K2's; those
    rows' aggregates and node cotangents are 0."""
    L, B = 128, 3
    rng = np.random.default_rng(seed)
    arrays, weights = _k1_arrays(rng, B, len(snd), rows, L)
    x = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    s, r = torch.tensor(snd).cuda(), torch.tensor(rcv).cuda()
    topo = (s, r, None, rows)
    e2, agg, a1, a2, _, _ = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo, plan=plan, save_streams=True)
    re2, ragg = fused_edge_block_reference(x["e"], x["sp"], x["rp"], w, *topo)
    (rt, at), (rta, ata) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=rt, atol=at)
    torch.testing.assert_close(agg, ragg, rtol=rta, atol=ata)
    assert bool((agg[:, N:] == 0).all())
    gen = torch.Generator().manual_seed(seed + 1)
    de2 = torch.randn(B, len(snd), L, generator=gen).to(dtype).cuda()
    drhs = agg_cotangent_rhs(agg, torch.randn(B, rows, 4 * L, generator=gen).cuda(), r, None, rows)
    got = fused_edge_block_bwd(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, plan=plan)
    want = fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2))
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    for name, g, h in zip(("de", "dh", "dz2", "dz3", "dsp", "drp"), got[:4] + got[6:8], want[:4] + want[6:8]):
        err = float((g.float() - h.float()).abs().max())
        assert err <= tol * (1 + float(h.float().abs().max())), name
    assert bool((got[6][:, N:] == 0).all()) and bool((got[7][:, N:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k1_k2_over_rmp_rows_match_plain(dtype):
    """The RMP path's mesh set: K1 and K2 with a plan over N + K rows (a
    12 x 12 grid and 16 hyper rows that receive no edge) against their plain
    versions, K1's tolerances and K2's; the hyper rows' aggregates and node
    cotangents are 0."""
    _need_card()
    snd, rcv, N = grid_edges(12, 12)
    rows = N + 16
    _check_k1_k2_over_rows(snd, rcv, N, rows, plan_segments(rcv, rows, senders=snd).to("cuda"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("frame, K, Kp", [(0, 10, 16), (2, 8, 8)], ids=["K10-Kp16", "K8-Kp8"])
def test_k1_k2_over_hdbscan_rows_match_plain(frame, K, Kp, dtype):
    """The mesh set's plan from HDBSCAN's clustering of a 10x10 flag
    (``min_cluster_size`` 5, ``max_cluster_size`` 30, with noise nodes):
    K = 10 padded to Kp = 16 at frame 0, K = Kp = 8 at frame 2, one
    expansion reclustered in turn; K1 and K2 over its N + Kp rows against
    their plain versions."""
    _need_card()
    config = _rmp_config(dtype=None)
    config["params"]["model"]["rmp"].update(
        clustering="hdbscan", hdbscan={"min_cluster_size": 5, "max_cluster_size": 30, "min_samples": 1})
    model = get_model(config)
    exp = build_expansion(model, config)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    topo = model.topology_from_trajectory(traj, device="cpu")
    for f in (0, 2):  # the other frame first when frame is 2: a change of Kp before the plan checked
        if f > frame:
            break
        exp.reset(0, 1)
        static = exp.prepare(model, {k: v[f] for k, v in traj.items()}, topo)[-1]
    rmp = exp.members[-1]
    assert (rmp._last_clustering.num_clusters, static.num_clusters) == (K, Kp)
    assert (rmp._last_clustering.labels < 0).any()
    N = topo.num_nodes
    plan = static.mesh_plan
    assert plan.num_nodes == N + Kp
    snd, rcv = topo.senders.numpy(), topo.receivers.numpy()
    _check_k1_k2_over_rows(snd, rcv, N, N + Kp, plan.to("cuda"), dtype)


def _rmp_shard_layout(G, chunk, nx=12, hyper=16, bands=None, group=None):
    """An nx x nx grid's edges laid out over G graph ranks as the sharded
    RMP step lays its mesh set out (``parallel.sharding.EdgeLayout``: padded,
    with ``chunk`` dealt round-robin), with interior masks (every seventh
    edge, and receiver 10's every edge, as the balancer's removals), and
    each rank's plan over N + ``hyper`` rows carrying the valid in-degree."""
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import EdgeLayout, rank_plans

    snd, rcv, N = grid_edges(nx, nx)
    rows = N + hyper
    layout = EdgeLayout.build(len(snd), G, chunk)
    inner = np.ones(len(snd), np.float32)
    inner[3::7] = 0.0
    inner[rcv == 10] = 0.0
    snd, rcv = layout.relay(snd, 0), layout.relay(rcv, N - 1)
    mask = layout.relay(inner, 0.0)
    group = group or RankGroup(G, device="cpu")
    plans = rank_plans(group, layout, snd, rcv, mask, rows, bands)
    return layout, snd, rcv, mask, rows, plans


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 32], ids=["contiguous", "round_robin"])
def test_k1_raw_and_k2_on_an_rmp_shard_with_masks_match_plain(chunk, dtype):
    """The sharded RMP step's mesh-set modes on every rank's shard: K1 raw
    (unfinalized partials) and K2 at the global in-degree, each plan over
    N + 16 rows, interior masks inside receivers' segments, against their
    plain versions (K1's and K2's tolerances); the hyper rows get no
    partials and no node cotangents."""
    _need_card()
    G = 2 if chunk is None else 4
    layout, snd, rcv, mask, rows, plans = _rmp_shard_layout(G, chunk)
    N, L, B = rows - 16, 128, 2
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(10)
    for k in range(G):
        sl = layout.shard(k)
        arrays, weights = _k1_arrays(rng, B, layout.per, rows, L)
        x = {a: torch.tensor(v).to(dtype).cuda() for a, v in arrays.items()}
        w = {a: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for a, v in weights.items()}
        topo = (torch.tensor(snd[sl]).cuda(), torch.tensor(rcv[sl]).cuda(), torch.tensor(mask[sl]).cuda(), rows)
        plan = plans.plans[k].to("cuda")
        e2, raw = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo, plan=plan, raw=True)
        re2, rraw = fused_edge_block_reference(x["e"], x["sp"], x["rp"], w, *topo, raw=True)
        (rt, at), (rta, ata) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
        torch.testing.assert_close(e2.float(), re2.float(), rtol=rt, atol=at)
        torch.testing.assert_close(raw, rraw, rtol=rta, atol=ata)
        assert bool((raw[:, N:, : 2 * L] == 0).all())
        e2, agg, a1, a2, _, _ = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo, plan=plan,
                                                     save_streams=True)
        de2 = torch.randn(B, layout.per, L, generator=gen).to(dtype).cuda()
        drhs = agg_cotangent_rhs(agg, torch.randn(B, rows, 4 * L, generator=gen).cuda(), topo[1], topo[2], rows,
                                 plan.degree)
        got = fused_edge_block_bwd(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, plan=plan)
        want = fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2))
        tol = 1e-4 if dtype == torch.float32 else 2.0**-6
        for name, g, h in zip(("de", "dh", "dz2", "dz3", "dsp", "drp"), got[:4] + got[6:8], want[:4] + want[6:8]):
            err = float((g.float() - h.float()).abs().max())
            assert err <= tol * (1 + float(h.float().abs().max())), (k, name)
        assert bool((got[7][:, N:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k7_over_rmp_rows_with_masks_matches_plain(dtype):
    """K7 on the sharded RMP step's overlap layout: 4 ranks' round-robin
    shards (32-edge chunks) of a 12 x 12 grid with interior masks, the
    bands over N + 16 rows; e2 K1's bit for bit, the aggregate K1 raw's
    with the plain all-reduce and the finalize."""
    _need_card()
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    group = RankGroup(4)
    layout, snd, rcv, mask, rows, plans = _rmp_shard_layout(4, 32, bands=4, group=group)
    rng = np.random.default_rng(11)
    L = 128
    arrays, weights = _k1_arrays(rng, 1, layout.per, rows, L)
    sp, rp = (torch.tensor(arrays[a][0]).to(dtype) for a in ("sp", "rp"))
    w = {a: torch.tensor(v.T.copy() if v.ndim == 2 else v) for a, v in weights.items()}
    shards = []
    for k in range(4):
        sl = layout.shard(k)
        shards.append(_on(dict(
            e=torch.tensor(rng.normal(size=(layout.per, L)).astype(np.float32)).to(dtype), sp=sp, rp=rp,
            weights=w, senders=torch.tensor(snd[sl]), receivers=torch.tensor(rcv[sl]),
            mask=torch.tensor(mask[sl])), group.device(k)))
        shards[k]["plan"] = plans.plans[k]
    _check_k7(shards, rows, group, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rmp", "balancer"])
def test_train_step_repeats_bit_for_bit(path):
    """Two train steps from one state, noise and static on the card, with
    no deterministic-algorithms setting: the same loss, gradients and
    normalizer states bit for bit (the unplanned sets' sums run in a fixed
    order; the kernels add in a fixed order)."""
    _need_card()
    assert not torch.are_deterministic_algorithms_enabled()
    config = _rmp_config(balancer=path == "balancer")
    traj = add_targets(flag_trajectory(num_steps=4, nx=12, ny=12), "world_pos", True)
    model = get_model(config)
    trainer = Trainer(model, config)
    topo = model.topology_from_trajectory(traj, device="cuda")
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    state = model.init_state(torch.Generator().manual_seed(1))
    frames = trainer.frames(traj)
    normal = torch.randn(traj["world_pos"].shape, generator=torch.Generator().manual_seed(2)).cuda()
    shape = trainer.expansion.hyper_noise_shape(model, frames, static)
    hyper = None if shape is None else torch.randn(shape, generator=torch.Generator().manual_seed(3)).cuda()
    runs = []
    for _ in range(2):
        ts = trainer.init_train_state(state=state)
        loss, norms = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        runs.append((loss.cpu(), [p.grad.cpu() for p in ts.model.params.parameters()],
                     [ns.acc_sum.cpu() for ns in norms.values()]))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(n0, n1))


@pytest.mark.cuda
def test_rmp_train_step_on_card_matches_cpu():
    """A float32 RMP train step (2 hierarchical blocks, 4 clusters) on the
    card against the CPU, same state, noise and static: loss rtol 1e-4,
    gradients within relative L2 1e-3, 2 K1 and 2 K2 on the card."""
    _need_card()
    config = _rmp_config()
    traj = add_targets(flag_trajectory(num_steps=4, nx=12, ny=12), "world_pos", True)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(1))
    normal = torch.randn(traj["world_pos"].shape, generator=torch.Generator().manual_seed(2))
    static = None
    results = {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(model, config, device=device)
        topo = model.topology_from_trajectory(traj, device=device)
        static = static or trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        st = tuple(s.to(device) for s in static)
        frames = trainer.frames(traj)
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, st),
                            generator=torch.Generator().manual_seed(3))
        before = (fused_edge_block.launches, fused_edge_block_bwd.launches)
        ts = trainer.init_train_state(state=state)
        loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal.to(device), static=st,
                                         hyper_normal=hyper.to(device))
        launched = (fused_edge_block.launches - before[0], fused_edge_block_bwd.launches - before[1])
        assert launched == ((2, 2) if device == "cuda" else (0, 0))
        results[device] = (float(loss), {n: p.grad.cpu() for n, p in ts.model.params.named_parameters()})
    (lc, gc), (lh, gh) = results["cuda"], results["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for name, g in gh.items():
        assert float((gc[name] - g).norm()) <= 1e-3 * float(g.norm()), name


# -- cylinder and plate ------------------------------------------------------------


def _model_config(name):
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml(name)
    config["params"]["model"].update(latent_size=32, message_passing_steps=2)
    return config


def _model_trajectory(name, num_steps=16):
    from hyper_graph_nets_tpu_torch.data import synthetic

    if name == "cylinder":
        return add_targets(synthetic.cylinder_trajectory(num_steps=num_steps, nx=12, ny=7), "velocity", False)
    return add_targets(synthetic.plate_trajectory(num_steps=num_steps, nx=9, ny=8), "world_pos", False)


@pytest.mark.cuda
def test_plate_world_edges_and_sums_need_no_host_sync():
    """Plate's world edges (radius query, slots by a running count, the
    receiver sort) and their fixed-order sums, built on the card for a batch
    of frames with contact, with every host sync an error: the same edges as
    the CPU builds, and the aggregate within float32 reordering (rtol 1e-5)
    of the CPU's."""
    from hyper_graph_nets_tpu_torch.core.segment_ops import aggregate

    _need_card()
    config = _model_config("plate")
    model = get_model(config)
    traj = _model_trajectory("plate")
    state = model.init_state(torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        topo = model.topology_from_trajectory(traj, device=device)
        frames = {k: torch.as_tensor(v[8:], device=device) for k, v in traj.items() if k != "cells"}
        st = state.to(device)
        torch.cuda.synchronize()
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                graph, aux, _ = model.make_graph(st, topo, frames, False)
                es = graph.edge_sets["world_edges"]
                agg = aggregate(es.features, es.receivers, topo.num_nodes, "pna", es.mask, sums=es.sums.receivers)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[device] = (es.senders.cpu(), es.receivers.cpu(), es.mask.cpu(), aux["world_truncated"].cpu(), agg.cpu())
    for a, b in zip(out["cuda"][:4], out["cpu"][:4]):
        assert torch.equal(a, b)
    assert int(out["cpu"][2].sum()) > 0
    torch.testing.assert_close(out["cuda"][4], out["cpu"][4], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cylinder", "plate"])
def test_model_train_step_on_card(name):
    """A float32 train step (2 blocks, latent 32, B = 4) of cylinder or plate
    on the card: 2 K1 and 2 K2; twice from one state and noise bit for bit;
    against the CPU on the same state (normalizers at their accumulation cap)
    and noise, loss rtol 1e-4 and gradients within relative L2 1e-3."""
    import dataclasses

    _need_card()
    config = _model_config(name)
    model = get_model(config)
    traj = _model_trajectory(name)
    batch = {k: v[8:12] for k, v in traj.items()}
    state = model.init_state(torch.Generator().manual_seed(1))
    topo_cpu = model.topology_from_trajectory(traj, device="cpu")
    with torch.no_grad():
        frames = {k: torch.as_tensor(v) for k, v in traj.items() if k != "cells"}
        _, _, state = model.make_graph(state, topo_cpu, frames, True)
        _, state = model.get_target(state, frames, True)
    state = state.replace(normalizers={
        k: dataclasses.replace(v, num_accumulations=torch.full_like(v.num_accumulations, v.max_accumulations))
        for k, v in state.normalizers.items()
    })
    field = "velocity" if name == "cylinder" else "world_pos"
    normal = torch.randn(batch[field].shape, generator=torch.Generator().manual_seed(2))
    runs = {}
    for device in ("cpu", "cuda", "cuda"):
        trainer = Trainer(model, config, device=device)
        topo = model.topology_from_trajectory(traj, device=device)
        ts = trainer.init_train_state(state=state)
        before = (fused_edge_block.launches, fused_edge_block_bwd.launches)
        loss, _ = trainer.loss_and_grads(ts, topo, trainer.frames(batch), normal=normal.to(device))
        launched = (fused_edge_block.launches - before[0], fused_edge_block_bwd.launches - before[1])
        assert launched == ((2, 2) if device == "cuda" else (0, 0))
        run = (loss.cpu(), [p.grad.cpu() for p in ts.model.params.parameters()])
        if device in runs:
            assert torch.equal(run[0], runs[device][0])
            assert all(torch.equal(a, b) for a, b in zip(run[1], runs[device][1]))
        runs[device] = run
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for a, b in zip(gg, gc):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm())


# -- HGN plate: valid-prefix plans and the train step -------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["up", "down", "inter"])
@pytest.mark.parametrize("L", [32, 128])
def test_k1_k2_on_valid_prefix_plans_match_plain(name, dtype, L):
    """K1 and K2 on a cluster-tier set planned over its valid prefix
    (``plan_segments(..., num_valid=)``; the up set's 150-edge segment spans
    three tiles, its masked tail of 12 non-members names hyper row 0, which
    has valid edges) against their plain versions, K1's tolerances and K2's:
    the tail reaches no aggregate and no receiver or sender cotangent."""
    from torch_port_cases import tier_set_case

    _need_card()
    arrays, weights, snd, rcv, mask, rows = tier_set_case(name, B=3, L=L)
    ev = int(mask.sum())
    x = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    topo = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), rows)
    plan = plan_segments(rcv, rows, senders=snd, num_valid=ev).to("cuda")
    e2, agg, a1, a2, _, _ = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo, plan=plan, save_streams=True)
    re2, ragg = fused_edge_block_reference(x["e"], x["sp"], x["rp"], w, *topo)
    (rt, at), (rta, ata) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=rt, atol=at)
    torch.testing.assert_close(agg, ragg, rtol=rta, atol=ata)
    valid = mask > 0
    no_recv = torch.tensor(np.bincount(rcv[valid], minlength=rows) == 0).cuda()
    no_send = torch.tensor(np.bincount(snd[valid], minlength=rows) == 0).cuda()
    assert bool((agg[:, no_recv] == 0).all())
    gen = torch.Generator().manual_seed(6)
    de2 = torch.randn(3, len(snd), L, generator=gen).to(dtype).cuda()
    drhs = agg_cotangent_rhs(agg, torch.randn(3, rows, 4 * L, generator=gen).cuda(), topo[1], topo[2], rows)
    got = fused_edge_block_bwd(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, plan=plan)
    want = fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2))
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    for n, g, h in zip(("de", "dh", "dz2", "dz3", "dsp", "drp"), got[:4] + got[6:8], want[:4] + want[6:8]):
        err = float((g.float() - h.float()).abs().max())
        assert err <= tol * (1 + float(h.float().abs().max())), n
    assert bool((got[6][:, no_send] == 0).all()) and bool((got[7][:, no_recv] == 0).all())


def _hgn_config(fused_tiers):
    config = _model_config("plateCluster")
    config["params"]["model"]["rmp"].update(num_clusters=4, fused_tiers=fused_tiers)
    return config


@pytest.mark.cuda
@pytest.mark.parametrize("fused_tiers", [False, True], ids=["tiers_off", "tiers_on"])
def test_hgn_plate_train_step_on_card(fused_tiers):
    """A float32 HGN-plate train step (plateCluster cut to 2 hierarchical
    blocks, latent 32 and 4 clusters, B = 4) on the card: 2 K1 and 2 K2 on
    the mesh set, 8 of each with ``fused_tiers`` (mesh, up, down, inter);
    twice from one state, noise and static bit for bit; against the CPU with
    the tiers unfused on the same state (normalizers at their accumulation
    cap), noise and static, loss rtol 1e-4 and every gradient within
    relative L2 1e-2 (the cluster tier's limit of chip_smoke.RMP_TOL; the
    mesh tier's 1e-3 for the rest)."""
    import dataclasses

    _need_card()
    traj = _model_trajectory("plate")
    batch = {k: v[8:12] for k, v in traj.items()}
    cpu_config, config = _hgn_config(False), _hgn_config(fused_tiers)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(1))
    state = state.replace(normalizers={
        k: dataclasses.replace(v, num_accumulations=torch.full_like(v.num_accumulations, v.max_accumulations))
        for k, v in state.normalizers.items()
    })
    normal = torch.randn(batch["world_pos"].shape, generator=torch.Generator().manual_seed(2))
    runs = {}
    for device, cfg in (("cpu", cpu_config), ("cuda", config), ("cuda", config)):
        m = get_model(cfg)
        trainer = Trainer(m, cfg, device=device)
        topo = m.topology_from_trajectory(traj, device=device)
        static = trainer.expansion.prepare(m, {k: v[0] for k, v in traj.items()}, topo)
        frames = trainer.frames(batch)
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(m, frames, static),
                            generator=torch.Generator().manual_seed(3))
        ts = trainer.init_train_state(state=state)
        before = (fused_edge_block.launches, fused_edge_block_bwd.launches)
        loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal.to(device), static=static,
                                         hyper_normal=hyper.to(device))
        launched = (fused_edge_block.launches - before[0], fused_edge_block_bwd.launches - before[1])
        n = 2 * (4 if fused_tiers else 1)
        assert launched == ((n, n) if device == "cuda" else (0, 0))
        run = (loss.cpu(), {k: p.grad.cpu() for k, p in ts.model.params.named_parameters()})
        if device in runs:
            assert torch.equal(run[0], runs[device][0])
            assert all(torch.equal(run[1][k], g) for k, g in runs[device][1].items())
        runs[device] = run
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    tier = ("hyper_", "inter_cluster", "intra_cluster_to_cluster", "intra_cluster_to_mesh")
    for k, g in gc.items():
        limit = 1e-2 if any(t in k for t in tier) else 1e-3
        assert float((gg[k] - g).norm()) <= limit * float(g.norm()), k


# -- int8 (W8A8) serving ------------------------------------------------------------


INT8_SHAPES = [
    (5, 4, 128),  # under _int_mm's 17 rows, K under 8: the world-edge encoder on few edges
    (16, 640, 128),  # 16 hyper rows
    (2000, 12, 128),  # K not a multiple of 8
    (2000, 128, 3),  # the decoder's last layer
    (2000, 7, 2),
    (3200, 128, 256),  # a node part: [ws; wr]
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("M, K, N", INT8_SHAPES, ids=[f"M{m}-K{k}-N{n}" for m, k, n in INT8_SHAPES])
def test_dense_int8_on_card_equals_cpu_bit_for_bit(M, K, N, dtype):
    """``dense_int8`` on the card (operands zero-padded to ``_int_mm``'s
    rules) against the CPU on the same inputs: bit for bit (the int32
    product is exact; the quantization and the epilogue are the same
    float32 operations in the same order), one ``_int_mm`` launch."""
    from hyper_graph_nets_tpu_torch.nn import quant

    _need_card()
    gen = torch.Generator().manual_seed(M + K + N)
    x = (torch.randn(M, K, generator=gen) * 4 * torch.rand(M, 1, generator=gen)).to(dtype)
    x[min(3, M - 1)] = 0.0
    w_q, ws = quant.quantize_weight(0.3 * torch.randn(N, K, generator=gen))
    want = quant.dense_int8(x, w_q, ws)
    before = quant.int8_matmul.calls
    got = quant.dense_int8(x.cuda(), w_q.cuda(), ws.cuda())
    assert quant.int8_matmul.calls == before + 1
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def _int8_layers_against_cpu(card, cpu, batch, monkeypatch):
    """The card's int8 one_step on ``batch`` layer by layer against the
    CPU's: the CPU's one_step records its dense layers' weights in call
    order, then the card's feeds each layer's input to the CPU layer of its
    rank.  Returns ``(dense layers, of them not bit for bit with the CPU's,
    the card's output)``.  Whole models are not compared: an activation one
    rounding from a code boundary may take the other code on the other
    device, and the next layers carry it on (tests/test_torch_port_int8.py)."""
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

    with monkeypatch.context() as mp:
        mp.setattr(quant, "dense_int8", recording)
        cpu.one_step(batch)
        mp.setattr(quant, "dense_int8", checking)
        got = card.one_step(batch)
    return len(mismatched), sum(mismatched) + abs(len(mismatched) - len(weights)), got


@pytest.mark.cuda
@pytest.mark.parametrize("agg_vjp", ["fused", "sorted"])
def test_int8_flag_one_step_on_card_matches_cpu(agg_vjp, monkeypatch):
    """``Predictor(quantize="int8")`` on a 2-block bf16 flag, on the card
    against the CPU from one float state: no K1 launch (an int8 set never
    fuses), 2 K4f with ``sorted``, 23 int8 products (the encoders' 3 + 3,
    each block's edge update 4 and node model 3, the decoder's 3), each bit
    for bit with the CPU's dense layer on the card's input."""
    from hyper_graph_nets_tpu_torch.nn import quant

    _need_card()
    config = flag_config("bfloat16", agg_vjp=agg_vjp)
    traj = add_targets(flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)
    state = get_model(config).init_state()
    card = Predictor(config, state=state, quantize="int8")
    cpu = Predictor(config, state=state, device="cpu", quantize="int8")
    before = (fused_edge_block.launches, pna_sorted.launches, quant.int8_matmul.calls)
    got = card.one_step(traj)
    launched = tuple(n - b for n, b in zip(
        (fused_edge_block.launches, pna_sorted.launches, quant.int8_matmul.calls), before))
    assert launched == (0, 2 if agg_vjp == "sorted" else 0, 23)
    assert np.isfinite(got).all()
    assert _int8_layers_against_cpu(card, cpu, traj, monkeypatch)[:2] == (23, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_tiers", [False, True], ids=["tiers_off", "tiers_on"])
def test_int8_hgn_plate_one_step_on_card_matches_cpu(fused_tiers, monkeypatch):
    """HGN plate (plateCluster cut to 2 hierarchical blocks, latent 32, 4
    clusters, float32) served int8 on the card against the CPU from one
    float state, each call reclustering its first frame on the host: no K1
    launch with the tiers off or on, and every dense layer bit for bit with
    the CPU's on the card's input."""
    _need_card()
    traj = _model_trajectory("plate")
    batch = {k: v[8:12] for k, v in traj.items()}
    config = _hgn_config(fused_tiers)
    state = get_model(config).init_state()
    card = Predictor(config, state=state, quantize="int8")
    cpu = Predictor(config, state=state, device="cpu", quantize="int8")
    before = fused_edge_block.launches
    layers, bad, got = _int8_layers_against_cpu(card, cpu, batch, monkeypatch)
    assert fused_edge_block.launches == before and np.isfinite(got).all()
    assert layers > 0 and bad == 0


# -- the sharded train step (parallel/sharding.py) -----------------------------

SPMD_STEP_LIMIT_S = 120  # a step that outlasts this ends the process (every thread's traceback)


def _sharded_vs_single(shape, bands, dtype_name):
    """The sharded step's loss and gradients and the single-device step's,
    on the card, from one state and one noise draw (a 2-block flag, B = 4,
    10x10 mesh; the overlap layout with 32-edge chunks)."""
    import faulthandler

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    config = flag_config(None if dtype_name == "float32" else dtype_name, agg_vjp="fused")
    config["params"]["model"].update(noise=0.003, gamma=0.9)
    model = get_model(config)
    trainer = Trainer(model, config)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames({k: np.array(v[:4]) for k, v in traj.items() if k != "cells"})
    normal = torch.randn(frames["world_pos"].shape, generator=torch.Generator().manual_seed(1)).cuda()
    state = model.init_state(torch.Generator().manual_seed(0))
    ts = trainer.init_train_state(state=state)
    ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal)
    ref = {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}
    group = RankGroup(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
    step = make_spmd_train_step(trainer, shard_topology(topo, group, overlap_bands=bands, chunk=32), group)
    runs = []
    faulthandler.dump_traceback_later(SPMD_STEP_LIMIT_S, exit=True)  # a deadlock fails, never hangs
    try:
        for _ in range(2):
            loss, _ = step.loss_and_grads(ts, frames, normal=normal)
            group.check()
            runs.append((loss, {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}))
    finally:
        faulthandler.cancel_dump_traceback_later()
    return runs, ref_loss, ref


@pytest.mark.cuda
def test_sharded_step_over_several_cards():
    """The sharded step over the default layout of several cards (rank r on
    ``cuda:(r % cards)``, at most 4): 2 x 2 (K1 raw, the plain all-reduce
    and K2 per shard, each on its card) and 1 x 4 with overlap bands (K7
    ringing across the cards), a 2-block float32 flag, B = 4, 10x10 mesh,
    against the same group on one card: loss rtol 1e-4 and gradients
    relative L2 1e-3 (the sharded card tests' float32 limits); the step
    with the cross-card gradient sum left out must miss the gradient limit;
    after three steps every card's parameter copy equals the state's
    parameters bit for bit, and two runs of three steps from one state are
    bit for bit.  Each case under its own time limit."""
    import faulthandler

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    _need_card()
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards")
    config = flag_config(None, agg_vjp="fused")
    config["params"]["model"].update(noise=0.003, gamma=0.9)
    model = get_model(config)
    trainer = Trainer(model, config)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames({k: np.array(v[:4]) for k, v in traj.items() if k != "cells"})
    normal = torch.randn(frames["world_pos"].shape, generator=torch.Generator().manual_seed(1)).cuda()
    state = model.init_state(torch.Generator().manual_seed(0))
    grads_of = lambda ts: {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))
    for shape, bands in (((2, 2), None), ((1, 4), 4)):
        one = RankGroup(*shape, devices=["cuda:0"] * 4)
        spread = RankGroup(*shape, devices=[f"cuda:{r % min(4, cards)}" for r in range(4)])
        assert len(set(spread.devices)) == min(4, cards)
        step = lambda group: make_spmd_train_step(
            trainer, shard_topology(topo, group, overlap_bands=bands, chunk=32), group)
        faulthandler.dump_traceback_later(SPMD_STEP_LIMIT_S, exit=True)  # a deadlock fails, never hangs
        try:
            ts = trainer.init_train_state(state=state)
            ref_loss, _ = step(one).loss_and_grads(ts, frames, normal=normal)
            one.check()
            ref = grads_of(ts)
            loss, _ = step(spread).loss_and_grads(ts, frames, normal=normal)
            spread.check()
            assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss)), shape
            for name, got in grads_of(ts).items():
                assert rel(got, ref[name]) <= 1e-3, (shape, name)
            planted = step(spread)
            planted._sum_over_devices = lambda params, per_device: None
            planted.loss_and_grads(ts, frames, normal=normal)
            spread.check()
            assert max(rel(got, ref[name]) for name, got in grads_of(ts).items()) > 1e-3, shape
            runs = []
            for _ in range(2):
                sstep, tst = step(spread), trainer.init_train_state(state=state)
                for _ in range(3):
                    tst, last = sstep(tst, frames, normal=normal)
                spread.check()
                home = {n: p.detach().cpu() for n, p in tst.model.params.named_parameters()}
                assert len(sstep.copies) == min(4, cards) - 1
                for kept in sstep.copies.values():
                    assert all(torch.equal(p.detach().cpu(), home[n]) for n, p in kept.named_parameters()), shape
                runs.append((last.cpu(), home))
            assert torch.equal(runs[0][0], runs[1][0]), shape
            assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1]), shape
        finally:
            faulthandler.cancel_dump_traceback_later()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2x2", "1x4_overlap"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_sharded_step_on_card_matches_single_device(case, dtype_name):
    """The sharded step over 4 ranks on one card (2 x 2: K1 raw + the plain
    all-reduce; 1 x 4 with bands: batched K7; K2 backward on both) against
    the single-device step on the card, same state and noise: the train
    step's card-vs-CPU limits (float32 loss rtol 1e-4, gradients relative L2
    1e-3; bf16 2**-5 and 2**-3); two runs bit for bit; each run under its
    own time limit."""
    _need_card()
    shape, bands = {"2x2": ((2, 2), None), "1x4_overlap": ((1, 4), 4)}[case]
    runs, ref_loss, ref = _sharded_vs_single(shape, bands, dtype_name)
    loss_tol, grad_tol = (1e-4, 1e-3) if dtype_name == "float32" else (2.0**-5, 2.0**-3)
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2) and all(torch.equal(grads[n], grads2[n]) for n in grads)
    assert abs(float(loss) - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    for name, want in ref.items():
        err = float((grads[name] - want).norm() / want.norm().clamp(min=1e-30))
        assert err <= grad_tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2x2", "1x4_overlap"])
def test_sharded_expansion_step_on_card_matches_single_device_and_repeats_after_another_static(case):
    """The sharded step with RMP and the Ricci balancer (a 2-block float32
    flag, 10x10, K = 4, B = 4) on 4 ranks of one card against the
    single-device step on the card (loss rtol 1e-4, gradients relative L2
    1e-3, the train step's card-vs-CPU limits); then the same step with a
    second static (every mesh plan's degree from the unmasked topology,
    which must move the gradients) and the first static again, whose
    gradients must equal the first run's bit for bit: each sharded backward
    reads every rank's forward tensors on one stream, and a rank's stream
    must not get their memory back before it has (``used_on_this_stream``)."""
    import faulthandler

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import (
        ShardedStatic,
        make_spmd_train_step,
        shard_topology,
        with_degree,
    )

    _need_card()
    shape, bands = {"2x2": ((2, 2), None), "1x4_overlap": ((1, 4), 4)}[case]
    config = flag_config(None, agg_vjp="fused")
    model_cfg = config["params"]["model"]
    model_cfg.update(noise=0.003, gamma=0.9)
    model_cfg["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": 4, "hyper_noise": 0.005}
    model_cfg["graph_balancer"] = {"algorithm": "ricci", "remove_edges": True, "ricci": {"loops": 10, "tau": 150}}
    model = get_model(config)
    trainer = Trainer(model, config)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames({k: np.array(v[:4]) for k, v in traj.items() if k != "cells"})
    gen = torch.Generator().manual_seed(1)
    normal = torch.randn(frames["world_pos"].shape, generator=gen).cuda()
    hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen).cuda()
    ts = trainer.init_train_state(state=model.init_state(torch.Generator().manual_seed(0)))
    grads = lambda: {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}
    ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
    ref = grads()
    group = RankGroup(*shape, devices=["cuda:0"] * 4)
    stopo = shard_topology(topo, group, overlap_bands=bands, chunk=32)
    step = make_spmd_train_step(trainer, stopo, group)
    laid = step.laid_out(static)
    rows = laid.members[1].mesh_plan.plans[0].num_nodes
    unmasked = torch.from_numpy(np.bincount(stopo.receivers.cpu().numpy()[stopo.mask.cpu().numpy() > 0],
                                            minlength=rows).astype(np.float32))
    control = ShardedStatic(
        topo=laid.topo._replace(plan=with_degree(laid.topo.plan, unmasked[: topo.num_nodes])),
        members=(laid.members[0], laid.members[1]._replace(mesh_plan=with_degree(laid.members[1].mesh_plan, unmasked))))
    runs = []
    faulthandler.dump_traceback_later(SPMD_STEP_LIMIT_S, exit=True)  # a deadlock fails, never hangs
    try:
        for st in (laid, control, laid):
            loss, _ = step.loss_and_grads(ts, frames, normal=normal, static=st, hyper_normal=hyper)
            group.check()
            runs.append((loss, grads()))
    finally:
        faulthandler.cancel_dump_traceback_later()
    (loss, got), (_, planted), (loss3, again) = runs
    assert torch.equal(loss, loss3) and all(torch.equal(got[n], again[n]) for n in got)
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    rel = lambda a, n: float((a[n] - ref[n]).norm() / ref[n].norm().clamp(min=1e-30))
    assert max(rel(got, n) for n in ref) <= 1e-3
    assert max(rel(planted, n) for n in ref) > max(rel(got, n) for n in ref)


# -- the sharded step on cylinder, plate and HGN plate -------------------------


@pytest.mark.cuda
def test_k1_raw_and_k2_on_an_hgn_plate_shard_in_float32_match_plain():
    """K1 raw and K2 at the global in-degree in float32 on each graph rank's
    shard of the 36x36 plate's mesh set (5,040 edges over 2 graph ranks),
    each plan over the 1,312 mesh rows and 16 hyper rows, as the sharded HGN
    plate step lays it out (``parallel.sharding.EdgeLayout``, ``rank_plans``),
    against their plain versions (float32 tolerances: K1 1e-5, K2 1e-4); the
    hyper rows and the stamp's rows, which receive no mesh edge, get no
    partials and no receiver cotangents."""
    from hyper_graph_nets_tpu_torch.data import synthetic
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import EdgeLayout, rank_plans

    _need_card()
    traj = add_targets(synthetic.plate_trajectory(num_steps=3, nx=36, ny=36), "world_pos", False)
    topo = get_model(_model_config("plate")).topology_from_trajectory(traj)
    N, G, L, B = topo.num_nodes, 2, 128, 2
    rows = N + 16
    snd, rcv = topo.senders.numpy(), topo.receivers.numpy()
    assert (N, len(snd), rows) == (1312, 5040, 1328)
    layout = EdgeLayout.build(len(snd), G)
    snd, rcv = layout.relay(snd, 0), layout.relay(rcv, N - 1)
    mask = layout.relay(np.ones(len(topo.senders), np.float32), 0.0)
    plans = rank_plans(RankGroup(G, device="cpu"), layout, snd, rcv, mask, rows)
    empty = torch.as_tensor(np.bincount(rcv[mask > 0], minlength=rows) == 0).cuda()
    assert bool(empty[N:].all()) and int(empty.sum()) > 16  # the hyper rows and the stamp's
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(12)
    for k in range(G):
        sl = layout.shard(k)
        arrays, weights = _k1_arrays(rng, B, layout.per, rows, L)
        x = {a: torch.tensor(v).cuda() for a, v in arrays.items()}
        w = {a: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for a, v in weights.items()}
        topo_k = (torch.tensor(snd[sl]).cuda(), torch.tensor(rcv[sl]).cuda(), torch.tensor(mask[sl]).cuda(), rows)
        plan = plans.plans[k].to("cuda")
        e2, raw = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo_k, plan=plan, raw=True)
        re2, rraw = fused_edge_block_reference(x["e"], x["sp"], x["rp"], w, *topo_k, raw=True)
        torch.testing.assert_close(e2, re2, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(raw, rraw, rtol=1e-5, atol=1e-5)
        assert bool((raw[:, empty, : 2 * L] == 0).all())
        e2, agg, a1, a2, _, _ = fused_edge_block_fwd(x["e"], x["sp"], x["rp"], w, *topo_k, plan=plan,
                                                     save_streams=True)
        de2 = torch.randn(B, layout.per, L, generator=gen).cuda()
        drhs = agg_cotangent_rhs(agg, torch.randn(B, rows, 4 * L, generator=gen).cuda(), topo_k[1], topo_k[2], rows,
                                 plan.degree)
        got = fused_edge_block_bwd(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo_k, plan=plan)
        want = fused_edge_block_bwd_reference(x["e"], x["sp"], x["rp"], w, de2, drhs, *topo_k, forward=(e2, a1, a2))
        for name, g, h in zip(("de", "dh", "dz2", "dz3", "dsp", "drp"), got[:4] + got[6:8], want[:4] + want[6:8]):
            err = float((g - h).abs().max())
            assert err <= 1e-4 * (1 + float(h.abs().max())), (k, name)
        assert bool((got[7][:, empty] == 0).all())


def _per_frame_shards(group, B, W, rows, F, seed=0):
    """A per-frame edge set like plate's world edges (``[B, W]`` receivers
    sorted, the valid slots first, ``W`` not a multiple of the graph axis),
    cut per rank as the sharded step cuts it (``cut_frame_set``) on the
    group's devices, each data rank's frames: ``(xs, sets)``, each rank's
    edge features (requiring grad) and its slice of the set."""
    from hyper_graph_nets_tpu_torch.core.graph import EdgeSet
    from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums
    from hyper_graph_nets_tpu_torch.parallel.sharding import cut_frame_set

    rng = np.random.default_rng(seed)
    hits = rng.integers(W // 3, W, B)
    rcv = np.zeros((B, W), np.int32)
    snd = np.zeros((B, W), np.int32)
    mask = np.zeros((B, W), np.float32)
    for b, h in enumerate(hits):
        rcv[b, :h] = np.sort(rng.integers(0, rows - 16, h))
        snd[b, :h] = rng.integers(0, rows - 16, h)
        mask[b, :h] = 1.0
    x = (np.round(rng.normal(size=(B, W, F)) * 4) / 4).astype(np.float32) * mask[..., None]
    D, G = group.shape["data"], group.shape["graph"]
    b = B // D
    xs, sets = [], []
    for r in range(group.n):
        d, g, dev = group.axis_index(r, "data"), group.axis_index(r, "graph"), group.device(r)
        fr = lambda a: torch.tensor(a[d * b : (d + 1) * b]).to(dev)
        s, rv, m = fr(snd), fr(rcv), fr(mask)
        whole = EdgeSet(features=fr(x), senders=s, receivers=rv, mask=m, sums=EdgeSums.per_frame(s, rv, m, rows))
        es = cut_frame_set(whole, G, g)
        xs.append(es.features.clone().requires_grad_())
        sets.append(es)
    return xs, sets


def _sharded_per_frame_aggregate(group, B, W, rows, F):
    from hyper_graph_nets_tpu_torch.core.segment_ops import sharded_aggregate

    xs, sets = _per_frame_shards(group, B, W, rows, F)
    outs = group.run(lambda r: sharded_aggregate(xs[r], sets[r].receivers, rows, "pna", sets[r].mask, group,
                                                 sums=sets[r].sums.receivers, ties="split"))
    group.check()
    gen = torch.Generator().manual_seed(4)
    ws = [torch.randn(o.shape, generator=gen).to(o.device) for o in outs]
    torch.autograd.backward([(o * w).sum() for o, w in zip(outs, ws)])
    return [o.detach().cpu() for o in outs], [x.grad.cpu() for x in xs]


@pytest.mark.cuda
def test_sharded_aggregate_on_per_frame_receivers_on_card_matches_cpu():
    """The sharded aggregate of a per-frame set (plate's world edges: 4
    frames of 127 slots, padded to 128 over 2 graph ranks, into 1,328 rows,
    tied values) on a 2 x 2 group on the card against the same on the CPU:
    each rank's aggregate and each shard's edge cotangent (every rank's
    cotangent summed, the mean's count and the tie counts per frame over
    every shard) within rtol = atol = 1e-6 (float32; the fixed-order sums
    take the same steps on both)."""
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup

    _need_card()
    args = (4, 127, 1328, 128)
    card = _sharded_per_frame_aggregate(RankGroup(2, 2, devices=["cuda:0"] * 4), *args)
    cpu = _sharded_per_frame_aggregate(RankGroup(2, 2, device="cpu"), *args)
    for got, want in zip(card[0] + card[1], cpu[0] + cpu[1]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plate", "plateCluster"])
def test_sharded_plate_step_on_card_matches_single_device(name):
    """The sharded step of plate and HGN plate (2 blocks, latent 32, float32,
    a 9x8 plate whose stamp and inner nodes share a 0.05-wide cube in every
    frame, so each frame forms tens of world edges; HGN plate with K = 4) on
    a 2 x 2 group of one card against the single-device step on the card,
    same state and noise: the train step's card-vs-CPU float32 limits (loss
    rtol 1e-4, gradients relative L2 1e-3); two runs bit for bit; each run
    under its own time limit."""
    import faulthandler

    from hyper_graph_nets_tpu_torch.core.graph import NodeType
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    _need_card()
    config = _model_config(name)
    config["params"]["model"].update(compute_dtype=None)
    if name == "plateCluster":
        config["params"]["model"]["rmp"]["num_clusters"] = 4
    model = get_model(config)
    trainer = Trainer(model, config)
    traj = _model_trajectory("plate", num_steps=8)
    nt = traj["node_type"][0][:, 0]
    close = (nt == NodeType.NORMAL) | (nt == NodeType.OBSTACLE)
    rng = np.random.RandomState(0)
    for key in ("world_pos", "target|world_pos"):
        traj[key][:, close] = (0.05 * rng.rand(traj[key].shape[0], int(close.sum()), 3)).astype(np.float32)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    static = None
    if trainer.expansion is not None:
        static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames({k: np.array(v[2:6]) for k, v in traj.items() if k != "cells"})
    gen = torch.Generator().manual_seed(1)
    normal = torch.randn(frames["world_pos"].shape, generator=gen).cuda()
    hyper = None
    if static is not None:
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen).cuda()
    ts = trainer.init_train_state(state=model.init_state(torch.Generator().manual_seed(0)))
    grads = lambda: {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}
    ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
    ref = grads()
    group = RankGroup(2, 2, devices=["cuda:0"] * 4)
    step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
    runs = []
    faulthandler.dump_traceback_later(SPMD_STEP_LIMIT_S, exit=True)  # a deadlock fails, never hangs
    try:
        for _ in range(2):
            loss, _ = step.loss_and_grads(ts, frames, normal=normal, static=static, hyper_normal=hyper)
            group.check()
            runs.append((loss, grads()))
    finally:
        faulthandler.cancel_dump_traceback_later()
    (loss, got), (loss2, again) = runs
    assert torch.equal(loss, loss2) and all(torch.equal(got[n], again[n]) for n in got)
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    for n, want in ref.items():
        err = float((got[n] - want).norm() / want.norm().clamp(min=1e-30))
        assert err <= 1e-3, (n, err)


# -- the hybrid (fused_fwd: xla): K2 with a tie tolerance ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k2_with_the_tie_tolerance_matches_plain(dtype):
    """K2 with the hybrid's tie tolerance against its plain version on K1's
    forward values, its drhs from the hybrid's own forward on the card (the
    unfused chain and the pna over the neighbour matrix, whose extrema sit a
    rounding away from K1's e2): K2's tolerances above; the routed max/min
    mass equals the count of K1's e2 within the tolerance of each extremum,
    and the tolerance leaves no more extrema without a winner than the exact
    compare does."""
    from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    _need_card()
    t, w, topo, plan, fwd, de2, _ = _bwd_inputs("masked", dtype, 128)
    e2, _, a1, a2, _, _ = fwd
    _, rcv, mask, N = topo
    gidx, gval = (torch.as_tensor(a).cuda() for a in receivers_to_gather(rcv.cpu().numpy(), N,
                                                                           mask=mask.cpu().numpy()))
    _, agg = fb.hybrid_forward(t["e"], t["sp"], t["rp"], w, topo[0], rcv, gidx, gval)
    tol = fb.HYBRID_TIE_TOL[dtype]
    L = e2.shape[-1]
    dagg = torch.randn(agg.shape, generator=torch.Generator().manual_seed(6)).cuda()
    drhs = agg_cotangent_rhs(agg, dagg, rcv, mask, N)
    before = (fused_edge_block_bwd.launches, fused_edge_block_bwd.tie_launches)
    got = fused_edge_block_bwd(t["e"], t["sp"], t["rp"], w, de2, drhs, *topo, plan=plan, tie_tol=tol)
    torch.cuda.synchronize()
    assert (fused_edge_block_bwd.launches, fused_edge_block_bwd.tie_launches) == (before[0] + 1, before[1] + 1)
    want = fused_edge_block_bwd_reference(t["e"], t["sp"], t["rp"], w, de2, drhs, *topo, forward=(e2, a1, a2),
                                          tie_tol=tol)
    _assert_bwd_close(got[:4] + got[6:], want[:4] + want[6:], dtype)
    # only g_max = g_min = 1: the routed mass counts the tolerant winners of K1's e2
    route = torch.zeros_like(dagg)
    route[..., 2 * L :] = 1.0
    rdrhs = agg_cotangent_rhs(agg, route, rcv, mask, N)
    got_rhs = rdrhs.to(dtype).float()[:, rcv.long()]
    valid = (mask > 0)[None, :, None]
    lost = {}
    for t_tol in (tol, 0.0):
        wins = sum(((fb.ties(e2.float(), got_rhs[..., k * L : (k + 1) * L], t_tol)) & valid).float().sum(dim=(0, 1))
                   for k in (1, 3))
        out = fused_edge_block_bwd(t["e"], t["sp"], t["rp"], w, torch.zeros_like(de2), rdrhs, *topo, plan=plan,
                                   tie_tol=t_tol)
        assert torch.equal(out[-1][4], wins), t_tol
        per = torch.zeros(e2.shape[0], N, L, device="cuda").index_add_(
            1, rcv.long(), (fb.ties(e2.float(), got_rhs[..., L : 2 * L], t_tol) & valid).float())
        has = torch.zeros(N, device="cuda").index_add_(0, rcv.long(), (mask > 0).float()) > 0
        lost[t_tol] = int(((per == 0) & has[None, :, None]).sum())
    assert lost[tol] <= lost[0.0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_train_step_on_card_matches_cpu(dtype):
    """A 2-block flag training step with ``fused_fwd: xla`` on the card
    (the unfused forward, then one K2 with the tie tolerance a block, no K1)
    against the CPU, same state and noise: the train step's card-vs-CPU
    limits above."""
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    _need_card()
    config = flag_config(None if dtype == "float32" else dtype, agg_vjp="fused")
    config["params"]["model"].update(noise=0.003, gamma=0.9, fused_fwd="xla")
    traj = add_targets(flag_trajectory(num_steps=4, nx=10, ny=10), "world_pos", True)
    model = get_model(config)
    state = model.init_state(torch.Generator().manual_seed(1))
    normal = torch.randn(traj["world_pos"].shape, generator=torch.Generator().manual_seed(2))
    results = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(model, config, device=device)
        tstate = trainer.init_train_state(state=state)
        topo = model.topology_from_trajectory(traj, device=device)
        before = (fused_edge_block.launches, fused_edge_block_bwd.launches, fb.fused_edge_block_bwd.tie_launches)
        loss, _ = trainer.loss_and_grads(tstate, topo, trainer.frames(traj), normal=normal.to(device))
        after = (fused_edge_block.launches, fused_edge_block_bwd.launches, fb.fused_edge_block_bwd.tie_launches)
        assert [a - b for a, b in zip(after, before)] == ([0, 2, 2] if device == "cuda" else [0, 0, 0])
        results[device] = (float(loss), {n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()})
    (lc, gc), (lh, gh) = results["cuda"], results["cpu"]
    loss_tol, grad_tol = (1e-4, 1e-3) if dtype == "float32" else (2.0**-5, 2.0**-3)
    assert abs(lc - lh) <= loss_tol * abs(lh)
    for name, g in gh.items():
        assert float((gc[name] - g).norm()) <= grad_tol * float(g.norm()), name


# -- the sharded step on the other RMP architectures ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["multiscale", "multi"])
def test_sharded_arch_step_on_card_matches_single_device(arch):
    """The sharded step with RMP ``multiscale`` (the mesh set fused twice a
    block: K1 raw + K2 per shard) and ``multi`` (the merged mesh set,
    unfused: no kernel) on a 2 x 2 group of one card (a 2-block float32
    flag, 10x10, K = 4, B = 4) against the single-device step on the card,
    same state and noise: loss rtol 1e-4, gradients relative L2 1e-3 (the
    train step's card-vs-CPU float32 limits); two runs bit for bit; each run
    under its own time limit."""
    import faulthandler

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology

    _need_card()
    config = flag_config(None, agg_vjp="fused")
    config["params"]["model"].update(noise=0.003, gamma=0.9)
    config["params"]["model"]["rmp"] = {"clustering": "spectral", "connector": arch, "num_clusters": 4,
                                        "hyper_noise": 0.005}
    model = get_model(config)
    trainer = Trainer(model, config)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames({k: np.array(v[:4]) for k, v in traj.items() if k != "cells"})
    gen = torch.Generator().manual_seed(1)
    normal = torch.randn(frames["world_pos"].shape, generator=gen).cuda()
    hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen).cuda()
    ts = trainer.init_train_state(state=model.init_state(torch.Generator().manual_seed(0)))
    grads = lambda: {n: p.grad.clone() for n, p in ts.model.params.named_parameters() if p.grad is not None}
    ref_loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
    ref = grads()
    group = RankGroup(2, 2, devices=["cuda:0"] * 4)
    step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
    runs = []
    count = lambda: (fused_edge_block.launches, fused_edge_block_bwd.launches)
    before = count()
    faulthandler.dump_traceback_later(SPMD_STEP_LIMIT_S, exit=True)  # a deadlock fails, never hangs
    try:
        for _ in range(2):
            loss, _ = step.loss_and_grads(ts, frames, normal=normal, static=static, hyper_normal=hyper)
            group.check()
            runs.append((loss, grads()))
    finally:
        faulthandler.cancel_dump_traceback_later()
    per_step = 2 * 2 * 4 if arch == "multiscale" else 0  # mesh sub-steps x blocks x ranks
    assert [a - b for a, b in zip(count(), before)] == [2 * per_step, 2 * per_step]
    (loss, got), (loss2, again) = runs
    assert torch.equal(loss, loss2) and all(torch.equal(got[n], again[n]) for n in got)
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    for n, want in ref.items():
        err = float((got[n] - want).norm() / want.norm().clamp(min=1e-30))
        assert err <= 1e-3, (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("agg_vjp", ["fused", "sorted"])
def test_pod_over_nccl_with_a_card_per_process_is_bit_for_bit(agg_vjp, tmp_path):
    """Two processes over ``nccl``, one card each, a ``1 x 2`` pod whose
    ``graph`` row spans them (tests/torch_port_pod_graph_worker.py: the
    aggregates, the cotangents in the backward and the gradients gathered
    on the cards), a 2-block float32 flag, B = 4, 10x10 mesh: each
    process's loss, gradients, parameters after Adam, normalizers and
    forward rows bit for bit with the in-process ``RankGroup(1, 2)`` over
    ``cuda:0`` and ``cuda:1``; the planted control (each process's nodes
    without the other's cotangents) misses the gradients by more than 1e-2
    relative L2.  Skips below two cards (NCCL takes one card a process)."""
    import os
    import socket
    import subprocess
    import sys

    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    import torch_port_pod_graph_worker as worker

    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card a process")
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    traj = add_targets(flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
    frames = {k: np.array(v[:4]) for k, v in traj.items() if k != "cells"}
    state = get_model(config).init_state(torch.Generator().manual_seed(0))
    case = dict(config=config, trajectory=traj, frames=frames, control=agg_vjp == "fused",
                normal=torch.randn(frames["world_pos"].shape, generator=torch.Generator().manual_seed(1)),
                params={n: p.detach().clone() for n, p in state.params.named_parameters()},
                normalizers=state.normalizers)
    src = str(tmp_path / "job.pt")
    torch.save(dict(backend="nccl", graph=2, devices=[["cuda:0"], ["cuda:1"]], cases={"flag": case}), src)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [str(tmp_path / f"out{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_port_pod_graph_worker.py"), str(r), "2",
                               str(port), src, outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        ref = worker.run_case(dict(case, control=False), lambda: RankGroup(1, 2, devices=["cuda:0", "cuda:1"]))
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r}:\n{log[-3000:]}"
    for r, out in enumerate(outs):
        got = torch.load(out, weights_only=False)["flag"]
        assert got["layout"]["shape"] == {"data": 1, "graph": 2} and got["layout"]["ranks"] == [r]
        assert torch.equal(got["loss"], ref["loss"]) and torch.equal(got["forward"], ref["forward"]), r
        for key in ("grads", "params"):
            for n, want in ref[key].items():
                assert torch.equal(got[key][n], want), (r, key, n)
        for k, fields in ref["normalizers"].items():
            for f, want in fields.items():
                assert torch.equal(got["normalizers"][k][f], want), (r, k, f)
        if case["control"]:
            worst = max(float((got["control_grads"][n] - g).norm() / g.norm().clamp(min=1e-30))
                        for n, g in ref["grads"].items())
            assert worst > 1e-2, (r, worst)
