"""The halo forward: the port over a rank group on the CPU against the JAX
package's shard_map halo forward on the virtual CPU devices.

The port's ranks run the kernels' plain versions (``RankGroup(n,
device="cpu")``); the JAX side runs its Pallas ring (K6) and overlap (K7)
kernels in interpret mode, as tests/test_ring.py and tests/test_overlap.py
do: the interpret state is reset and the caches cleared around each JAX
ring, a mismatch is retried once after a reset (the emulator's RDMA
semaphores run on host threads and can race under load), and rings stay at
4 devices or fewer so the emulator has spare devices.

Tolerances:
- K6's plain version against JAX's ring: per rank, float32 within 1e-6
  (both fold the same partials; XLA may fuse the adds differently).  The
  plain fold order itself is checked exactly.
- ``collective_aggregate`` against JAX's under ``shard_map``: float32
  within 1e-5 (the local segment sums run in another order).
- K1 raw and K7's plain version against the JAX kernels: float32 within
  1e-5, as K1 (tests/test_torch_port_kernel.py): the products and the
  aggregate's sums run in another order.  K7's plain e2 equals the port's
  K1 on the same shard exactly, as JAX's equals its own.
- ``shard_topology``: the same edges, padding and mask as JAX's, exactly.
- The whole halo forward (2 blocks, latent 32, 6x6 flag): float32 within
  rtol 1e-4 and atol 2e-5 of JAX's halo forward and of the port's
  single-device forward (JAX's own tolerance, test_overlap.py:308).  bf16
  within 2**-3 absolute and 2**-5 relative, the per-block tolerance of
  tests/test_torch_port_model.py: both sides round to bf16 after every
  product, but XLA on the CPU may skip a rounding inside an elementwise
  chain, and the rank partials are summed in bf16 in another order.  Every
  rank's output agrees with rank 0's within the same tolerance.
"""
import ctypes
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from hyper_graph_nets_tpu.core import segment_ops as jax_segment_ops
from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.ops.pallas.fused_block import (
    _edge_weights,
    _fwd_call,
    _pad_to_plan,
    band_plan_specs,
    build_band_plan,
    build_sharded_band_plans,
)
from hyper_graph_nets_tpu.ops.pallas.fused_overlap import fused_edge_block_collective_overlap
from hyper_graph_nets_tpu.ops.pallas.ring import ring_all_reduce_segments as jax_ring
from hyper_graph_nets_tpu.parallel import halo as jax_halo
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums, collective_aggregate
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    fused_edge_block_fwd,
    fused_edge_block_reference,
)
from hyper_graph_nets_tpu_torch.ops.fused_overlap import (
    chunk_roundrobin_permutation,
    fused_edge_block_overlap,
    fused_edge_block_overlap_reference,
)
from hyper_graph_nets_tpu_torch.ops.ring import (
    ring_all_reduce_segments,
    ring_all_reduce_segments_reference,
)
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph
from hyper_graph_nets_tpu_torch.parallel.sharding import RankPlans, RankSums, shard_topology
from torch_port_cases import flag_config, masked_edge_case

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("graph",))


def _reset():
    pltpu.reset_tpu_interpret_mode_state()
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    _reset()
    yield


def _jax_with_retry(compute, check):
    """``check(compute())``, once more after a full interpret-state reset if
    it fails (test_ring.py:36-49)."""
    try:
        check(compute())
    except AssertionError:
        _reset()
        check(compute())


def _torch_rank_shards(arr, n):
    per = arr.shape[0] // n
    return [torch.tensor(arr[r * per : (r + 1) * per]) for r in range(n)]


# -- K6 ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_k6_plain_matches_jax_ring(n):
    R, C = 6, 8
    x = np.random.RandomState(n).randn(n * 3 * R, C).astype(np.float32)
    segments = [(0, R, "sum"), (R, 2 * R, "max"), (2 * R, 3 * R, "min")]
    got = ring_all_reduce_segments(_torch_rank_shards(x, n), segments, RankGroup(n, device="cpu"))

    ring = jax.shard_map(
        lambda v: jax_ring(v, segments, "graph"),
        mesh=_mesh(n), in_specs=P("graph"), out_specs=P("graph"), check_vma=False,
    )

    def check(out):
        want = np.asarray(out).reshape(n, 3 * R, C)
        for r in range(n):
            np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-6, atol=1e-6)

    _jax_with_retry(lambda: jax.jit(ring)(jnp.asarray(x)), check)


def test_k6_plain_folds_in_the_jax_ring_order():
    """Rank r gets ((x_r + x_{r-1}) + x_{r-2}) + ..., exactly; max and min
    segments fold the same ranks; rows outside every segment keep x_r."""
    n = 4
    xs = [torch.randn(10, 5, generator=torch.Generator().manual_seed(r)) for r in range(n)]
    segments = [(0, 4, "sum"), (4, 6, "max"), (6, 8, "min")]
    got = ring_all_reduce_segments_reference(xs, segments)
    for r in range(n):
        want = xs[r][:4].clone()
        for s in range(1, n):
            want = want + xs[(r - s) % n][:4]
        assert torch.equal(got[r][:4], want)
        assert torch.equal(got[r][4:6], torch.stack([x[4:6] for x in xs]).amax(0))
        assert torch.equal(got[r][6:8], torch.stack([x[6:8] for x in xs]).amin(0))
        assert torch.equal(got[r][8:], xs[r][8:])


# -- collective_aggregate ------------------------------------------------------


@pytest.mark.parametrize("ring", [False, True], ids=["plain", "ring"])
def test_collective_aggregate_matches_jax(ring):
    n, N, E, F = 4, 12, 40, 6
    rng = np.random.RandomState(7)
    ids = np.sort(rng.randint(0, N - 2, E)).astype(np.int32)  # the last two rows empty
    data = rng.randn(E, F).astype(np.float32)
    mask = np.ones(E, np.float32)
    mask[-6:] = 0.0  # masked padding edges
    ids[-6:] = N - 1

    group = RankGroup(n, device="cpu")
    shards = [_torch_rank_shards(a, n) for a in (data, ids, mask)]
    got = group.run(
        lambda r: collective_aggregate(shards[0][r], shards[1][r], N, "pna", shards[2][r], group, ring=ring)
    )

    def local(d, i, m):
        return jax_segment_ops.collective_aggregate(d, i, N, "pna", m, "graph", ring=ring)

    fn = jax.shard_map(
        local, mesh=_mesh(n), in_specs=(P("graph"), P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=False,
    )

    def check(out):
        want = np.asarray(out).reshape(n, N, 4 * F)
        for r in range(n):
            np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-5, atol=1e-5)
        assert np.all(got[0][N - 2 :].numpy() == 0)

    _jax_with_retry(lambda: jax.jit(fn)(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask)), check)


@pytest.mark.parametrize("ring", [False, True], ids=["plain", "ring"])
def test_collective_aggregate_in_fixed_order(ring):
    """With each shard's fixed-order sums (``EdgeSums.build`` on the shard,
    as ``shard_topology`` builds them) the aggregate equals the
    ``index_add_`` one within float32 reordering (rtol 1e-6) and is the
    same bit for bit on a second call; ``shard_topology`` gives every rank
    the sums of its own slice and ``split_graph`` hands them on."""
    n, N, E, F = 4, 12, 40, 6
    rng = np.random.RandomState(8)
    ids = np.sort(rng.randint(0, N - 2, E)).astype(np.int32)
    data = rng.randn(E, F).astype(np.float32)
    mask = np.ones(E, np.float32)
    mask[-6:] = 0.0
    ids[-6:] = N - 1
    group = RankGroup(n, device="cpu")
    d, i, m = (_torch_rank_shards(a, n) for a in (data, ids, mask))
    sums = [EdgeSums.build(np.zeros(len(i[r]), np.int32), i[r].numpy(), N) for r in range(n)]
    run = lambda fixed: group.run(
        lambda r: collective_aggregate(d[r], i[r], N, "pna", m[r], group, ring=ring,
                                       sums=sums[r].receivers if fixed else None)
    )
    atomic, fixed, again = run(False), run(True), run(True)
    for r in range(n):
        np.testing.assert_allclose(fixed[r].numpy(), atomic[r].numpy(), rtol=1e-6, atol=1e-6)
        assert torch.equal(fixed[r], again[r]) and torch.equal(fixed[r], fixed[0])

    model = get_model(flag_config(None, agg_vjp="xla"))
    traj = jax_add_targets(jax_flag_trajectory(num_steps=3, nx=6, ny=6), "world_pos", True)
    stopo = shard_topology(model.topology_from_trajectory(traj), group)
    assert isinstance(stopo.sums, RankSums) and len(stopo.sums.sums) == n
    per = stopo.senders.shape[0] // n
    for r, es in enumerate(stopo.sums.sums):
        torch.testing.assert_close(es.receivers.ids, stopo.receivers[r * per : (r + 1) * per].long())
        torch.testing.assert_close(es.senders.ids, stopo.senders[r * per : (r + 1) * per].long())
    state = model.init_state()
    graph, _, _ = model.make_graph(state, stopo, {k: torch.as_tensor(v[0]) for k, v in traj.items()}, False)
    for r, g in enumerate(split_graph(graph, group)):
        assert g.edge_sets["mesh_edges"].sums is stopo.sums.sums[r]


# -- K1 raw and K7 -------------------------------------------------------------


def _torch_weights(weights):
    return {k: torch.tensor(v.T.copy() if v.ndim == 2 else v) for k, v in weights.items()}


def test_k1_raw_plain_matches_jax_unfinalized_kernel():
    arrays, weights, snd, rcv, mask, N, num_valid = masked_edge_case(seed=4, B=1, L=128)
    plan = build_band_plan(snd, rcv, N, num_valid=num_valid, chunk=128)
    e3, sp3, rp3 = (jnp.asarray(arrays[k]) for k in ("e", "sp", "rp"))
    e_pad, sp_pad, rp_pad = _pad_to_plan(e3, sp3, rp3, plan, N)
    je2, jraw = _fwd_call(
        e_pad, sp_pad, rp_pad, _edge_weights({k: jnp.asarray(v) for k, v in weights.items()}),
        plan, interpret=True, finalize=False,
    )
    t = {k: torch.tensor(v) for k, v in arrays.items()}
    e2, raw = fused_edge_block_fwd(
        t["e"], t["sp"], t["rp"], _torch_weights(weights), torch.tensor(snd), torch.tensor(rcv),
        torch.tensor(mask), N, raw=True,
    )
    E = len(snd)
    np.testing.assert_allclose(
        e2[0, :num_valid].numpy(), np.asarray(je2)[0, :num_valid], rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(raw[0].numpy(), np.asarray(jraw)[0, :N], rtol=1e-5, atol=1e-5)
    assert raw.shape == (1, N, 4 * 128) and e2.shape == (1, E, 128)
    assert np.all(raw[0, 10, 2 * 128 : 3 * 128].numpy() == -1e30)  # receiver 10 has no edge
    assert np.all(raw[0, 10, 3 * 128 :].numpy() == 1e30)


def _overlap_problem(S, E_per=64, N=96, L=128, seed=0, chunk=32):
    """tests/test_overlap.py's problem: S contiguous shards of a sorted
    edge list with 8 padding edges at the end."""
    rng = np.random.RandomState(seed)
    E = E_per * S
    rcv = np.sort(rng.randint(0, N, E)).astype(np.int32)
    snd = np.clip(rcv + rng.randint(-8, 9, E), 0, N - 1).astype(np.int32)
    ev = E - 8
    rcv[ev:] = N - 1
    snd[ev:] = N - 1
    plan = build_sharded_band_plans(snd, rcv, N, S, num_valid=ev, chunk=chunk, overlap_bands=4)
    e = rng.randn(E, L).astype(np.float32)
    sp = rng.randn(N, L).astype(np.float32)
    rp = rng.randn(N, L).astype(np.float32)
    w = {k: (rng.randn(L, L) * 0.1).astype(np.float32) for k in ("we", "w2", "w3")}
    w.update({k: (rng.randn(L) * 0.1).astype(np.float32) for k in ("b1", "b2", "b3", "lnb")})
    w["lns"] = (rng.randn(L) * 0.1 + 1).astype(np.float32)
    mask = np.zeros(E, np.float32)
    mask[:ev] = 1.0
    return plan, e, sp, rp, w, N, snd, rcv, mask


@pytest.mark.parametrize("S", [2, 3, 4])
def test_k7_plain_matches_jax_overlap_kernel(S):
    plan, e, sp, rp, w, N, snd, rcv, mask = _overlap_problem(S)

    def body(e_l, sp_l, rp_l, w_l, p_l):
        return fused_edge_block_collective_overlap(e_l, sp_l, rp_l, w_l, p_l, N, "graph")

    sm = jax.shard_map(
        body, mesh=_mesh(S), in_specs=(P("graph"), P(), P(), P(), band_plan_specs(P, plan)),
        out_specs=(P("graph"), P()), check_vma=False,
    )
    tw = _torch_weights(w)
    shards = [
        dict(e=es, sp=torch.tensor(sp), rp=torch.tensor(rp), weights=tw, senders=ss, receivers=rs, mask=ms)
        for es, ss, rs, ms in zip(*(_torch_rank_shards(a, S) for a in (e, snd, rcv, mask)))
    ]
    group = RankGroup(S, device="cpu")
    before = fused_edge_block_overlap.launches
    got = fused_edge_block_overlap(shards, N, group, bands=4)
    assert fused_edge_block_overlap.launches == before  # the CPU runs the plain version
    assert len(got) == S
    per = e.shape[0] // S
    for r, x in enumerate(shards):
        e2, _ = fused_edge_block_reference(
            x["e"], x["sp"], x["rp"], tw, x["senders"], x["receivers"], x["mask"], N
        )
        assert torch.equal(got[r][0], e2)  # K1's e2 on the same shard

    def check(out):
        je2, jagg = (np.asarray(o) for o in out)
        valid = mask > 0
        for r in range(S):
            sl = slice(r * per, (r + 1) * per)
            np.testing.assert_allclose(
                got[r][0].numpy()[valid[sl]], je2[sl][valid[sl]], rtol=1e-5, atol=1e-5
            )
            np.testing.assert_allclose(got[r][1].numpy(), jagg, rtol=1e-5, atol=1e-5)

    _jax_with_retry(lambda: jax.jit(sm)(e, sp, rp, w, plan), check)


def test_k7_plain_ranks_agree_and_match_the_separate_pass():
    """K7's plain version: every rank's aggregate equals K1 raw + the plain
    all-reduce + finalize within 1e-6 (float32 sums in the ring's order)."""
    from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block_spmd

    S = 3
    _, e, sp, rp, w, N, snd, rcv, mask = _overlap_problem(S, seed=2)
    tw = _torch_weights(w)
    group = RankGroup(S, device="cpu")
    shards = [_torch_rank_shards(a, S) for a in (e, snd, rcv, mask)]
    sep = group.run(
        lambda r: fused_edge_block_spmd(
            shards[0][r], torch.tensor(sp), torch.tensor(rp), tw, shards[1][r], shards[2][r],
            shards[3][r], N, None, group,
        )
    )
    ov = fused_edge_block_overlap_reference(
        [dict(e=es, sp=torch.tensor(sp), rp=torch.tensor(rp), weights=tw, senders=ss, receivers=rs, mask=ms)
         for es, ss, rs, ms in zip(*shards)], N,
    )
    for r in range(S):
        assert torch.equal(ov[r][0], sep[r][0])
        torch.testing.assert_close(ov[r][1], sep[r][1], rtol=1e-6, atol=1e-6)


# -- shard_topology ------------------------------------------------------------


def test_chunk_roundrobin_permutation_matches_jax():
    from hyper_graph_nets_tpu.ops.pallas.fused_overlap import (
        chunk_roundrobin_permutation as jax_perm,
    )

    for E, S, chunk in ((1024, 4, 256), (96, 3, 8), (64, 2, 32)):
        np.testing.assert_array_equal(chunk_roundrobin_permutation(E, S, chunk), jax_perm(E, S, chunk))
    with pytest.raises(ValueError):
        chunk_roundrobin_permutation(100, 3, 8)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """A JAX model state (seeded weights, normalizers accumulated over a 6x6
    flag trajectory) and the trajectory, made once: the weights and
    normalizers do not depend on the compute dtype or the aggregation path."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=5, nx=6, ny=6), "world_pos", True)
    jmodel = jax_get_model(flag_config(None))
    jstate = jmodel.init_state(jax.random.PRNGKey(0))
    topo = jmodel.build_topology(traj["cells"][0])
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    _, _, jstate = jmodel.make_graph(jstate, topo, frames, True)
    _, jstate = jmodel.get_target(jstate, frames, True)
    return jstate, traj


def _flag_setup(dtype, agg_vjp):
    """The JAX model, its state, the port's model and converted state, and
    the trajectory."""
    config = flag_config(None if dtype == "float32" else dtype, agg_vjp=agg_vjp)
    jstate, traj = _jax_state()
    params = jax.tree.map(np.asarray, jstate.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in jstate.normalizers.items()
    }
    return jax_get_model(config), jstate, get_model(config), state_from_jax_numpy(params, normalizers), traj


@pytest.mark.parametrize("overlap_bands", [None, 4], ids=["contiguous", "round_robin"])
def test_shard_topology_matches_jax(overlap_bands):
    config = flag_config(None)
    jmodel, model = jax_get_model(config), get_model(config)
    traj = jax_add_targets(jax_flag_trajectory(num_steps=3, nx=6, ny=6), "world_pos", True)
    n = 4
    jst = jax_sharding.shard_topology(
        jmodel.topology_from_trajectory(traj), jax_sharding.make_mesh(graph=n), overlap_bands=overlap_bands
    )
    group = RankGroup(n, device="cpu")
    st = shard_topology(model.topology_from_trajectory(traj), group, overlap_bands=overlap_bands)
    for a, b in ((st.senders, jst.senders), (st.receivers, jst.receivers), (st.mask, jst.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert isinstance(st.plan, RankPlans) and len(st.plan.plans) == n
    per = len(st.senders) // n
    for r, plan in enumerate(st.plan.plans):
        assert plan.num_edges == per and plan.overlap_bands == (overlap_bands or 0)
        assert np.all(np.diff(st.receivers[r * per : (r + 1) * per].numpy()) >= 0)
    if overlap_bands:
        # every rank's shard is chunks of the padded list dealt round-robin
        assert len(st.senders) % (256 * n) == 0


# -- K7's work list and the group launches' arguments ---------------------------


def _work_cases():
    """``{name: (receivers, mask, N)}``: the 40x40 flag's four overlap
    shards (padded and dealt round-robin by 256-edge chunks, as
    ``shard_topology`` does), and a 10x10 grid's receiver-sorted edges
    followed by a tail of masked padding edges at receiver N-1 that is
    empty, shorter than a tile, longer than two tiles, or the whole shard."""
    from hyper_graph_nets_tpu_torch.parallel.sharding import DEFAULT_CHUNK, pad_to_multiple
    from torch_port_cases import grid_edges

    cases = {}
    _, rcv, N = grid_edges(40, 40)
    n, E = 4, len(rcv)
    padded = pad_to_multiple(rcv, DEFAULT_CHUNK * n, N - 1)
    mask = (np.arange(len(padded)) < E).astype(np.float32)
    perm = chunk_roundrobin_permutation(len(padded), n, DEFAULT_CHUNK)
    padded, mask = padded[perm], mask[perm]
    per = len(padded) // n
    for r in range(n):
        cases[f"flag40 rank {r}"] = (padded[r * per : (r + 1) * per], mask[r * per : (r + 1) * per], N)
    _, rcv, N = grid_edges(10, 10)
    for name, valid, tail in (("no tail", len(rcv), 0), ("tail under a tile", len(rcv), 23),
                              ("tail over two tiles", len(rcv), 150), ("all tail", 0, 100)):
        cases[name] = (
            np.concatenate([rcv[:valid], np.full(tail, N - 1, rcv.dtype)]),
            np.concatenate([np.ones(valid, np.float32), np.zeros(tail, np.float32)]),
            N,
        )
    return cases


@pytest.mark.parametrize("case", list(_work_cases()))
def test_k7_work_list_covers_each_edge_once_and_counts_each_band(case):
    """K7's work list as the wrapper builds it (``overlap_work``): every edge
    lies in exactly one item, the tail items (the masked edges after the last
    valid one) have no receivers and so touch no band, and for every band
    split the count a band's ring waits for (the kernel counts the items
    whose receivers meet its rows) equals the counts the compute teams add
    (one per band an item's rows touch) and the items that hold an edge or
    an empty row of the band."""
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import band_rows, overlap_work, ring_ctas

    rcv, mask, N = _work_cases()[case]
    work = overlap_work(rcv, mask, N)
    groups, edges = work.groups.numpy(), work.group_edges.numpy()
    E, nv = len(rcv), work.num_valid
    assert nv == (np.flatnonzero(mask > 0)[-1] + 1 if (mask > 0).any() else 0)
    # every edge in exactly one item, in order
    assert edges[0] == 0 and edges[-1] == E and np.all(np.diff(edges) >= 0)
    owner = np.repeat(np.arange(work.num_items), np.diff(edges))
    assert len(owner) == E
    # the valid prefix's items own whole receiver segments, up to num_valid
    row_ptr = work.row_ptr.numpy()
    assert row_ptr[0] == 0 and row_ptr[N] == nv
    for g in range(work.num_groups):
        assert edges[g] == row_ptr[groups[g]] and edges[g + 1] == row_ptr[groups[g + 1]]
        assert np.all((rcv[edges[g] : edges[g + 1]] >= groups[g]) & (rcv[edges[g] : edges[g + 1]] < groups[g + 1]))
    assert groups[work.num_groups] == N
    # the tail: items of at most TILE edges, no receivers, every edge masked
    tail = range(work.num_groups, work.num_items)
    assert len(tail) == -(-(E - nv) // 64)
    for g in tail:
        assert groups[g] == groups[g + 1] == N and 0 < edges[g + 1] - edges[g] <= 64
    assert not (mask[nv:] > 0).any()
    for nb in (1, 4, ring_ctas(4, 33), 64):
        rb = band_rows(N, nb)
        for b in range(nb):
            lo, hi = b * rb, min(N, (b + 1) * rb)
            waits = sum(int(groups[g] < hi and groups[g + 1] > lo) for g in range(work.num_items))
            adds = sum(
                int(groups[g + 1] > groups[g] and groups[g] // rb <= b <= (groups[g + 1] - 1) // rb)
                for g in range(work.num_items)
            )
            touching = sum(int(bool(set(range(groups[g], groups[g + 1])) & set(range(lo, hi))))
                           for g in range(work.num_items))
            assert waits == adds == touching, (nb, b)


def test_group_launch_arguments_are_in_rank_order_with_each_neighbour():
    """The per-rank entries that K6's and K7's single C call takes
    (``ring.rank_state``, ``ring.struct_array``, ``ring.rank_table``): entry
    r holds rank r's own flags, slots and counters, its left neighbour's
    flags and its right neighbour's flags and slots; the group keeps the
    table until its ring state grows; the ctypes layouts are the C structs'
    (pointers 8 bytes, ints 4, each pointer 8-aligned)."""
    from hyper_graph_nets_tpu_torch.ops import fused_overlap as fo
    from hyper_graph_nets_tpu_torch.ops import ring

    n = 4
    group = RankGroup(n, device="cpu")
    state = group.ring_state("k6", 64)
    rows = ring.rank_state(group, state)
    assert len(rows) == n
    for r, row in enumerate(rows):
        (slots, flags, counters), left, right = state[r], state[(r - 1) % n], state[(r + 1) % n]
        assert (row["flags_mine"], row["slot_mine"], row["counters"]) == (
            flags.data_ptr(), slots.data_ptr(), counters.data_ptr())
        assert row["flags_left"] == left[1].data_ptr()
        assert (row["flags_right"], row["slot_right"]) == (right[1].data_ptr(), right[0].data_ptr())
        assert (row["device"], row["stream"]) == (-1, 0)
    arr = ring.struct_array(ring.RingRank, [dict(row, x=1000 + r, out=2000 + r) for r, row in enumerate(rows)])
    assert ctypes.sizeof(ring.RingRank) == 7 * 8 + 8 + 8
    for r in range(n):
        assert (arr[r].x, arr[r].out) == (1000 + r, 2000 + r)
        for name in ("flags_mine", "flags_left", "flags_right", "slot_mine", "slot_right", "device"):
            assert getattr(arr[r], name) == rows[r][name]
    # the group keeps its table until its ring state changes
    table = ring.rank_table(group, state, ring.RingRank)
    assert ring.rank_table(group, state, ring.RingRank) is table
    for r in range(n):
        for name in ("flags_mine", "flags_left", "flags_right", "slot_mine", "slot_right", "device", "stream"):
            assert (getattr(table[r], name) or 0) == rows[r][name]  # a null c_void_p reads None
    grown = group.ring_state("k6", 128)
    assert grown is not state and ring.rank_table(group, grown, ring.RingRank) is not table
    zeros = {name: 0 for name, _ in fo.OvRank._fields_}
    arr7 = ring.struct_array(fo.OvRank, [dict(zeros, **row, E=10 + r) for r, row in enumerate(rows)])
    assert ctypes.sizeof(fo.OvRank) == 19 * 8 + 3 * 4 + 4 + 6 * 8 + 8 + 8
    for r in range(n):
        assert arr7[r].E == 10 + r
        for name in ("flags_mine", "flags_left", "flags_right", "slot_mine", "slot_right", "counters"):
            assert getattr(arr7[r], name) == rows[r][name]


# -- the whole halo forward -----------------------------------------------------

PATHS = {"fused": ("fused", False, False), "ring": ("xla", True, False), "overlap": ("fused", False, True)}


@pytest.mark.parametrize(
    "path,dtype",
    [("fused", "float32"), ("ring", "float32"), ("overlap", "float32"), ("fused", "bfloat16")],
)
def test_halo_forward_matches_jax_and_single_device(path, dtype):
    agg_vjp, ring, overlap = PATHS[path]
    jmodel, jstate, model, state, traj = _flag_setup(dtype, agg_vjp)
    n, bands = 4, 4 if overlap else None
    frame_np = {k: v[0] for k, v in traj.items() if k != "cells"}

    mesh = jax_sharding.make_mesh(graph=n)
    jst = jax_sharding.shard_topology(jmodel.topology_from_trajectory(traj), mesh, overlap_bands=bands)
    jframe = {k: jnp.asarray(v) for k, v in frame_np.items()}
    jgraph, _, _ = jmodel.make_graph(jstate, jst, jframe, False, batched=False)
    jfwd = jax_halo.make_halo_forward(jmodel, mesh, ring=ring, overlap=overlap)

    group = RankGroup(n, device="cpu")
    topo = model.topology_from_trajectory(traj)
    frame = {k: torch.as_tensor(v) for k, v in frame_np.items()}
    with torch.no_grad():
        graph, _, _ = model.make_graph(state, shard_topology(topo, group, overlap_bands=bands), frame, False)
        single_graph, _, _ = model.make_graph(state, topo, frame, False)
        single = model.forward(state, single_graph).numpy()
    outs = make_halo_forward(model, group, ring=ring, overlap=overlap)(
        state, split_graph(graph, group), all_ranks=True
    )
    got = [o.numpy() for o in outs]
    rtol, atol = (1e-4, 2e-5) if dtype == "float32" else (2.0**-5, 2.0**-3)
    for r in range(n):
        np.testing.assert_allclose(got[r], got[0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got[0], single, rtol=rtol, atol=atol)
    assert got[0].shape == (36, 3) and np.isfinite(got[0]).all()

    def check(out):
        np.testing.assert_allclose(got[0], np.asarray(out), rtol=rtol, atol=atol)

    _jax_with_retry(lambda: jfwd(jstate.params, jgraph), check)
