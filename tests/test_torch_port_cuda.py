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
