"""HyperGraphNets on plate (configs/plateCluster.yaml) in the port against the
JAX package: the fixed-order frame sums over the hyper tier's rows, the K1/K2
plans over a cluster-tier set's valid prefix, ``prepare``'s static and plans
with ``rmp.fused_tiers`` off and on, serving, the train step on every
``agg_vjp`` path, the task loop and a JAX checkpoint.

Inputs are made with numpy (the synthetic plate, seeded) and go through both
packages: a 5x6 quad plate and a 3x3 stamp (39 nodes, world edges from frame
10 on), ``configs/plateCluster.yaml`` cut to latent 16, 2 blocks and K = 4
spectral clusters (the stamp left out of the clustering), float32 unless a
test says bf16.  The JAX side runs its Pallas kernels in interpret mode
(tests/conftest.py); the port, on the CPU, each kernel's plain version.  The
plate is 5x6, not square (a square grid makes the ``mesh_edge`` normalizer
standardize float32 rounding: ROADMAP section 3, standing findings).

Tolerances (each test's docstring names its own):

- plans, static arrays, labels and the frame sums' order: exact;
- the frame sums against ``index_add_``: rtol 1e-6 (float32 reordering);
- K1/K2 plain against the JAX kernel on a tier set (float32): e2 and the
  aggregate rtol 1e-5, atol 1e-5; gradients atol 3e-4 (edge and node rows)
  and 3e-3 (weights) with rtol 1e-4, those of tests/test_fused_block.py;
- one_step, rollout positions and n-step losses (float32): rtol 1e-5, atol
  1e-6 of the positions (the same operations summed in another order);
- loss rtol 1e-5; gradients rtol 1e-4, atol 1e-4 of each tensor's largest
  element; normalizer states rtol 1e-5 (tests/test_torch_port_rmp.py's).  The
  port's fused paths (K1/K2's plain versions, on the mesh set and with
  ``fused_tiers`` on the tier sets) are held against the JAX ``gather``
  path, which routes a tied max/min cotangent in full as K2 does;
- bf16 (fused_tiers): held against JAX's ``gather`` path in bf16 (the JAX
  fused bf16 remat backward does not reproduce its own forward in interpret
  mode, ROADMAP section 3): the loss rtol 2**-8 (read 7.7e-5), all the
  gradients together within relative L2 2**-4 (read 0.019) and each tensor
  within relative L2 0.5 (read up to 0.19).  Per tensor the bf16 spread is
  wide on this plate whatever the path: the port's own ``gather``, ``xla``
  and fused paths read 0.23-0.36 on the up set's edge model against JAX's
  ``gather``, and 0.015-0.028 all together, since a bf16 rounding (2**-8)
  that lands on the other side in one package moves a cluster mean of
  about 8 members, and the tier models see 4 such rows a frame.
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.ops.pallas.fused_block import (
    build_band_plan,
    fused_edge_block as jax_fused_edge_block,
)
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core.segment_ops import (
    EdgeSums,
    FrameSum,
    gather_fixed,
    segment_sum_fixed,
)
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import plate_trajectory
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import fused_block
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    EDGE_WEIGHT_KEYS,
    TILE,
    fused_edge_block_reference,
    plan_segments,
)
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training import checkpoint
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.task import get_task
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import tier_set_case
from torch_port_models import cut_config, numpy_state

K = 4
TIER_SETS = ("intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster")
PLANS = {"intra_cluster_to_cluster": "up_plan", "intra_cluster_to_mesh": "down_plan",
         "inter_cluster": "inter_plan", "inter_cluster_world": "inter_world_plan"}
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def hgn_config(agg_vjp="fused", fused_tiers=False, dtype=None, inter_world=False, **model):
    """configs/plateCluster.yaml at latent 16, 2 blocks and K = 4."""
    config = cut_config("plateCluster", agg_vjp, **model)
    config["params"]["model"]["compute_dtype"] = dtype
    config["params"]["model"]["rmp"].update(num_clusters=K, fused_tiers=fused_tiers,
                                            inter_cluster_world=inter_world)
    return config


@functools.lru_cache(maxsize=None)
def _traj(num_steps=20):
    return add_targets(plate_trajectory(num_steps=num_steps, nx=5, ny=6, seed=0), "world_pos", False)


def _frames(sl):
    return {k: np.asarray(v[sl]) for k, v in _traj().items() if k != "cells"}


class JaxSide:
    """The JAX model of a config, its expansion prepared on ``frame`` (the
    trajectory's first by default) and its topology of the trajectory."""

    def __init__(self, config, frame=None):
        self.config = config
        self.model = jax_get_model(config)
        self.exp = jax_build_expansion(self.model, config)
        self.topo = self.model.topology_from_trajectory(_traj())
        self.static = self.exp.prepare(self.model, frame or {k: v[0] for k, v in _traj().items()}, self.topo)


@functools.lru_cache(maxsize=None)
def _jax_state(inter_world=False):
    """A JAX init whose normalizers (the RMP ones too) have seen the
    trajectory in training mode; it serves every path and type (the
    parameters and the normalizers are float32 whatever the path)."""
    side = JaxSide(hgn_config("gather", inter_world=inter_world))
    frames = {k: jnp.asarray(v) for k, v in _traj().items() if k != "cells"}

    def accumulate(state, frames):
        graph, _, state = side.model.make_graph(state, side.topo, frames, True)
        _, state = side.exp.expand(state, graph, frames, side.model, True, key=jax.random.PRNGKey(3),
                                   static=side.static)
        return side.model.get_target(state, frames, True)[1]

    return jax.jit(accumulate)(side.model.init_state(jax.random.PRNGKey(0)), frames)


def _port_state(inter_world=False):
    return state_from_jax_numpy(*numpy_state(_jax_state(inter_world)))


# -- the fixed-order frame sums over the hyper rows ----------------------------


@pytest.mark.parametrize("B, W, N, extra", [(3, 37, 11, 4), (2, 64, 30, 16), (1, 5, 3, 1)])
def test_frame_sum_with_rows_equals_index_add(B, W, N, extra):
    """``FrameSum.with_rows`` (the world set re-rowed to ``N + K`` by the
    connector): sums and gathers over the ``N + K`` rows equal ``index_add``
    and indexing over them (rtol 1e-6), the hyper rows stay empty, the
    sort order and scan masks are the plan's own, and a masked element's
    ``spread`` (the sum's backward) is 0, exactly."""
    rng = np.random.default_rng(W)
    ids = torch.tensor(rng.integers(0, N, size=(B, W)))
    mask = torch.tensor((rng.random((B, W)) > 0.3).astype(np.float32))
    mask[:, -1] = 0  # a masked element in every frame
    plan = FrameSum.build(ids, mask, N)
    rows = N + extra
    wide = plan.with_rows(rows)
    assert wide.num_segments == rows and torch.equal(wide.order, plan.order)
    assert all(torch.equal(a, b) for a, b in zip(wide.same, plan.same))
    assert torch.equal(wide.key, torch.where(mask > 0, ids, rows))
    x = torch.tensor(rng.normal(size=(B, W, 5)).astype(np.float32), requires_grad=True)
    got = segment_sum_fixed(x, wide)
    batch = torch.arange(B)[:, None].expand(B, W)
    want = torch.zeros(B, rows, 5).index_put_((batch, ids), x * mask[..., None], accumulate=True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[:, :N], segment_sum_fixed(x, plan)) and not got[:, N:].any()
    g = torch.tensor(rng.normal(size=(B, rows, 5)).astype(np.float32))
    (dx,) = torch.autograd.grad(got, x, g)
    assert not dx[mask == 0].any()
    assert torch.equal(dx, torch.gather(g, 1, ids[..., None].expand(B, W, 5)) * mask[..., None])
    nodes = torch.tensor(rng.normal(size=(B, rows, 5)).astype(np.float32), requires_grad=True)
    gathered = gather_fixed(nodes, wide)
    assert torch.equal(gathered, torch.gather(nodes, 1, ids[..., None].expand(B, W, 5)))
    gr = torch.tensor(rng.normal(size=(B, W, 5)).astype(np.float32))
    (dn,) = torch.autograd.grad(gathered, nodes, gr)
    np.testing.assert_allclose(
        dn.numpy(), torch.zeros(B, rows, 5).index_put_((batch, ids), gr * mask[..., None], accumulate=True),
        rtol=1e-6, atol=1e-6,
    )
    sums = EdgeSums.per_frame(ids.flip(-1), ids, mask, N).with_rows(rows)
    assert sums.receivers.num_segments == sums.senders.num_segments == rows


# -- K1/K2 plans over a cluster-tier set's valid prefix -------------------------


@pytest.mark.parametrize("name", ["up", "down", "inter"])
def test_plan_over_a_valid_prefix(name):
    """``plan_segments(..., num_valid=)`` on a tier set whose masked tail
    (non-members, padded pairs) names receivers out of order: the segments
    cover the valid prefix only, exactly (each receiver's edges are its
    valid ones); the tail rides in receiver-less groups of at most TILE
    edges; every edge lies in exactly one group; the full-set plan of these
    receivers is refused, and the up set's biggest cluster is a segment
    longer than a tile (150 edges, as plate's 81-edge ones)."""
    _, _, snd, rcv, mask, rows = tier_set_case(name)
    ev = int(mask.sum())
    assert (mask[:ev] > 0).all() and not mask[ev:].any()
    if name != "down":  # down's tail (obstacle ids after the members) happens to be sorted
        with pytest.raises(ValueError, match="non-decreasing"):
            plan_segments(rcv, rows, senders=snd)
    plan = plan_segments(rcv, rows, senders=snd, num_valid=ev)
    row_ptr, groups, ge = (t.numpy().astype(np.int64) for t in (plan.row_ptr, plan.groups, plan.group_edges))
    assert plan.num_edges == len(rcv) and plan.num_nodes == rows and row_ptr[-1] == ev
    np.testing.assert_array_equal(np.diff(row_ptr), np.bincount(rcv[:ev], minlength=rows))
    covered = np.zeros(len(rcv), int)
    for g in range(plan.num_groups):
        covered[ge[g] : ge[g + 1]] += 1
        if ge[g] >= ev:  # the masked tail
            assert groups[g] == groups[g + 1] == rows and ge[g + 1] - ge[g] <= TILE
        else:
            assert ge[g] == row_ptr[groups[g]] and ge[g + 1] == row_ptr[groups[g + 1]]
    assert (covered == 1).all()
    assert ge[-1] == len(rcv) and (len(rcv) == ev or groups[-2] == rows)
    if name == "up":
        assert np.diff(row_ptr).max() == 150 > TILE
    perm, ptr = plan.snd_perm.numpy(), plan.snd_ptr.numpy()
    np.testing.assert_array_equal(snd[perm], np.sort(snd, kind="stable"))
    np.testing.assert_array_equal(np.diff(ptr), np.bincount(snd, minlength=rows))
    with pytest.raises(ValueError, match="num_valid"):
        plan_segments(rcv, rows, num_valid=len(rcv) + 1)


@pytest.mark.parametrize("name", ["up", "down", "inter"])
def test_k1_k2_plain_on_a_valid_prefix_equal_jax(name):
    """K1's plain version and ``FusedEdgeBlock``'s backward (K2's plain
    version) on a tier set with a masked tail, against the JAX kernels
    (``_fwd_kernel``/``_bwd_kernel`` in interpret mode) over the band plan
    with ``num_valid``, float32, latent 32, B = 2: e2 on the valid edges and
    the aggregate rtol 1e-5, atol 1e-5 (the tail's e2 is a documented
    design difference: ROADMAP section 3, 'Padding edges'); gradients of
    ``vdot(e2 * mask, ge2) + vdot(agg, gagg)`` atol 3e-4 (edge and node
    rows) and 3e-3 (weights), rtol 1e-4, as tests/test_fused_block.py's."""
    arrays, weights, snd, rcv, mask, rows = tier_set_case(name)
    ev = int(mask.sum())
    rng = np.random.default_rng(9)
    B, E, L = arrays["e"].shape
    ge2 = (rng.normal(size=(B, E, L)) * mask[None, :, None]).astype(np.float32)
    gagg = rng.normal(size=(B, rows, 4 * L)).astype(np.float32)
    bplan = build_band_plan(snd, rcv, rows, num_valid=ev, chunk=128)

    def jloss(e, sp, rp, w):
        e2, agg = jax_fused_edge_block(e, sp, rp, w, bplan, rows, interpret=True)
        return jnp.vdot(e2 * mask[None, :, None], ge2) + jnp.vdot(agg, gagg), (e2, agg)

    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    (_, (je2, jagg)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(arrays[k]) for k in ("e", "sp", "rp")), jw
    )
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v, requires_grad=True) for k, v in weights.items()}
    idx = (torch.tensor(snd), torch.tensor(rcv), torch.tensor(mask))
    plan = plan_segments(rcv, rows, senders=snd, num_valid=ev)
    e2, agg = fused_block.fused_edge_block(t["e"], t["sp"], t["rp"], w, *idx, rows, plan=plan)
    re2, ragg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, *idx, rows)
    assert torch.equal(e2, re2) and torch.equal(agg, ragg)
    np.testing.assert_allclose(e2.detach().numpy()[:, :ev], np.asarray(je2)[:, :ev], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(jagg), rtol=1e-5, atol=1e-5)
    loss = (e2 * idx[2][None, :, None] * torch.tensor(ge2)).sum() + (agg * torch.tensor(gagg)).sum()
    leaves = [t["e"], t["sp"], t["rp"]] + [w[k] for k in EDGE_WEIGHT_KEYS]
    grads = torch.autograd.grad(loss, leaves)
    want = dict(zip(("e", "sp", "rp"), jg[:3]), **jg[3])
    for n, g in zip(["e", "sp", "rp"] + list(EDGE_WEIGHT_KEYS), grads):
        g = g.numpy().T if n in ("we", "w2", "w3") else g.numpy()
        atol = 3e-4 if n in ("e", "sp", "rp") else 3e-3
        np.testing.assert_allclose(g, np.asarray(want[n]), rtol=1e-4, atol=atol, err_msg=n)
    assert not grads[0][:, ev:].any()  # the masked tail reaches nothing


# -- prepare: the static and the plans -------------------------------------------


def _port_side(config, frame=None):
    model = get_model(config)
    exp = build_expansion(model, config)
    topo = model.topology_from_trajectory(_traj(), device="cpu")
    static = exp.prepare(model, frame or {k: v[0] for k, v in _traj().items()}, topo)
    return model, exp, topo, static


def _contact_frame():
    """Frame 12 with the stamp's nine nodes moved onto nine plate nodes
    spread over the plate (1e-3 above each), so that world edges reach every
    cluster: the frame ``prepare`` takes for ``inter_cluster_world`` (on the
    5x6 plate the stamp's own contact reaches one node).  The stamp is left
    out of the clustering, so the labels are frame 12's."""
    frame = {k: np.array(v[12]) for k, v in _traj().items()}
    obstacle = np.flatnonzero(frame["node_type"][:, 0] == 1)
    plate = np.flatnonzero(frame["node_type"][:, 0] == 0)
    frame["world_pos"][obstacle] = frame["world_pos"][plate[:: len(plate) // len(obstacle)][: len(obstacle)]] + 1e-3
    return frame


def _assert_static_equal(got, want):
    for f in want._fields:
        b = getattr(want, f)
        if f.endswith("_plan") or b is None:
            continue
        a = getattr(got, f)
        for x, y in zip(a if isinstance(b, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)


def _assert_plans_match(static, jstatic, rows):
    """A port plan exactly where the JAX package has a band plan, over the
    same valid prefix (the JAX plan's ``m_col`` count) and ``rows`` rows."""
    for name, field in PLANS.items():
        plan, jplan = getattr(static, field), getattr(jstatic, field)
        assert (plan is None) == (jplan is None), name
        if plan is not None:
            assert plan.num_nodes == rows
            assert int(plan.row_ptr[-1]) == int(np.asarray(jplan.m_col).sum()), name


@pytest.mark.parametrize("fused_tiers", [False, True], ids=["tiers_off", "tiers_on"])
def test_prepare_static_and_plans_match_jax(fused_tiers):
    """``prepare`` on the plate's first frame: labels (-1 on the stamp),
    every static array equal to the JAX package's, the mesh set's plan over
    ``N + K`` rows, and a tier plan exactly where JAX attaches a band plan
    (none with ``fused_tiers`` off; up, down and inter with it on)."""
    config = hgn_config("fused", fused_tiers)
    jside = JaxSide(config)
    model, exp, topo, (static,) = _port_side(config)
    (jstatic,) = jside.static
    _assert_static_equal(static, jstatic)
    obstacle = model.obstacle_mask_np({k: v[0] for k, v in _traj().items()})
    labels = exp.members[0]._last_clustering.labels
    assert (labels[obstacle] == -1).all() and (labels[~obstacle] >= 0).all()
    rows = topo.num_nodes + K
    assert static.mesh_plan.num_nodes == rows and jside.topo.band_plan is not None
    _assert_plans_match(static, jstatic, rows)
    assert (static.up_plan is not None) == fused_tiers


def test_tier_plans_follow_jax_window_rule():
    """A 46 x 46 plate (2,132 nodes, random clusters): the up set's sender
    window passes 2,048 rows, so neither package fuses it; down and inter
    are fused in both."""
    config = hgn_config("fused", True)
    config["params"]["model"]["rmp"]["clustering"] = "random"
    traj = add_targets(plate_trajectory(num_steps=3, nx=46, ny=46, seed=0), "world_pos", False)
    frame = {k: v[0] for k, v in traj.items()}
    jmodel = jax_get_model(config)
    (jstatic,) = jax_build_expansion(jmodel, config).prepare(jmodel, frame, jmodel.topology_from_trajectory(traj))
    model = get_model(config)
    topo = model.topology_from_trajectory(traj, device="cpu")
    (static,) = build_expansion(model, config).prepare(model, frame, topo)
    _assert_plans_match(static, jstatic, topo.num_nodes + K)
    assert static.up_plan is None and static.down_plan is not None and static.inter_plan is not None


# -- serving --------------------------------------------------------------------


FORWARD_CASES = [("fused", False), ("fused", True), ("xla", False), ("gather", False), ("sorted", False)]
SERVE_FRAMES = slice(12, 18)


@functools.lru_cache(maxsize=None)
def _jax_one_step(agg_vjp="gather", fused_tiers=False):
    """The JAX ``Predictor``'s one_step of the serving frames (its call
    reclusters their first frame)."""
    jp = JaxPredictor(hgn_config(agg_vjp, fused_tiers))
    jp.state = _jax_state()
    return jp.one_step({k: v[SERVE_FRAMES] for k, v in _traj().items()})


@functools.lru_cache(maxsize=None)
def _jax_rollout_and_n_step():
    """The JAX ``gather`` path's 4-step rollout and its 2-step n-step losses
    over 5 frames, the expansion prepared on the first frame."""
    jside = JaxSide(hgn_config("gather"))
    jops, jmse = jside.model.rollout(_jax_state(), jside.topo, _traj(), num_steps=4, expansion=jside.exp)
    jm, jl = jside.model.n_step_computation(_jax_state(), jside.topo, _traj(), n_step=2, num_timesteps=5,
                                            expansion=jside.exp)
    return np.asarray(jops["pred_pos"]), np.asarray(jmse), [float(jm), float(jl)]


@pytest.mark.parametrize("agg_vjp, fused_tiers", FORWARD_CASES,
                         ids=["fused", "fused_tiers", "xla", "gather", "sorted"])
def test_one_step_rollout_and_n_step_match_jax(agg_vjp, fused_tiers):
    """``Predictor.one_step`` on 6 frames with contact (each call reclusters
    its first frame), a 4-step rollout and the 2-step n-step losses over 5
    frames, float32, each path against the JAX ``gather`` path, which
    computes the same forward (positions rtol 1e-5, atol 1e-6; the rollout's
    MSE rtol 1e-4, a difference of nearly equal positions; n-step losses
    rtol 1e-5); with ``fused_tiers`` the one_step also against the JAX
    package's own fused path with its tier plans, its kernels in interpret
    mode on the mesh set and the three tier sets.  Nothing launches a kernel
    on the CPU."""
    config = hgn_config(agg_vjp, fused_tiers)
    state = _port_state()
    k1 = fused_block.fused_edge_block.launches
    got = Predictor(config, state=state, device="cpu").one_step({k: v[SERVE_FRAMES] for k, v in _traj().items()})
    np.testing.assert_allclose(got, _jax_one_step(), rtol=1e-5, atol=1e-6)
    if fused_tiers:
        np.testing.assert_allclose(got, _jax_one_step("fused", True), rtol=1e-5, atol=1e-6)
    jpos, jmse, jn = _jax_rollout_and_n_step()
    model, exp, topo, static = _port_side(config)
    with torch.no_grad():
        ops, mse = model.rollout(state, topo, _traj(), num_steps=4, expansion=exp, static=static)
        m, last = model.n_step_computation(state, topo, _traj(), n_step=2, num_timesteps=5, expansion=exp,
                                           static=static)
    np.testing.assert_allclose(ops["pred_pos"].numpy(), jpos, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mse.numpy(), jmse, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose([m, last], jn, rtol=1e-5)
    assert fused_block.fused_edge_block.launches == k1


# -- training --------------------------------------------------------------------


STEP_KEY = jax.random.PRNGKey(11)
TRAIN_FRAMES = slice(12, 18)


@functools.lru_cache(maxsize=None)
def _jax_reference(dtype=None, inter_world=False):
    """The JAX ``gather`` path's loss, gradients (as the port's parameters)
    and normalizer states of ``make_train_step``'s loss_fn on the train
    frames, with JAX's own noise draws from ``STEP_KEY`` (``trainer.py:159``);
    the expansion prepared as the port's is in the test."""
    jconfig = hgn_config("gather", dtype=dtype, inter_world=inter_world, noise=0.003, gamma=0.9)
    jside = JaxSide(jconfig, _contact_frame() if inter_world else None)
    model, jstate = jside.model, _jax_state(inter_world)
    _, nkey, ekey = jax.random.split(STEP_KEY, 3)
    frames = {k: jnp.asarray(v) for k, v in _frames(TRAIN_FRAMES).items()}
    frames = jax_add_noise(frames, model.field, model.noise_scale, model.noise_gamma, nkey)

    def loss_fn(params, normalizers):
        mstate = JModelState(params=params, normalizers=normalizers)
        graph, _, mstate = model.make_graph(mstate, jside.topo, frames, True)
        graph, mstate = jside.exp.expand(mstate, graph, frames, model, is_training=True, key=ekey,
                                         static=jside.static)
        target, mstate = model.get_target(mstate, frames, is_training=True)
        out = jax_batched_forward(model, mstate.params, graph)
        mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, normalizers), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate.normalizers
    )
    return float(loss), state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params, normalizers


def _jax_draws(step_key, field_shape, hyper_shape):
    _, nkey, ekey = jax.random.split(step_key, 3)
    _, sub = jax.random.split(ekey)
    draw = lambda k, s: torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
    return draw(nkey, field_shape), draw(sub, hyper_shape)


TRAIN_CASES = [
    # (agg_vjp, fused_tiers, fused_bwd, dtype, inter_world)
    ("fused", False, "remat", None, False),
    ("fused", True, "remat", None, False),
    ("fused", True, "stream", None, False),
    ("gather", False, "remat", None, False),
    ("xla", False, "remat", None, False),
    ("sorted", False, "remat", None, False),
    ("fused", True, "remat", "bfloat16", False),
    ("fused", True, "remat", None, True),
]


@pytest.mark.parametrize(
    "agg_vjp, fused_tiers, bwd, dtype, inter_world", TRAIN_CASES,
    ids=["fused", "fused_tiers", "fused_tiers-stream", "gather", "xla", "sorted", "fused_tiers-bf16",
         "fused_tiers-inter_world"],
)
def test_loss_and_grads_match_jax(agg_vjp, fused_tiers, bwd, dtype, inter_world):
    """``Trainer.loss_and_grads`` on 6 frames with contact, with JAX's field
    and hyper noise draws, against the JAX ``gather`` path's loss, gradients
    and normalizer states (float32: loss rtol 1e-5, gradients rtol 1e-4 and
    atol 1e-4 of each tensor's largest element, normalizers rtol 1e-5; bf16
    as the module's docstring says).  With
    ``fused_tiers`` the tier sets run K1/K2's plain versions over their
    valid-prefix plans (asserted); the ``inter_cluster_world`` case
    prepares on a frame whose stamp touches every cluster
    (:func:`_contact_frame`), so the inter-world set has edges (and its own
    plan)."""
    want_loss, want_grads, want_norms = _jax_reference(dtype, inter_world)
    config = hgn_config(agg_vjp, fused_tiers, dtype, inter_world, noise=0.003, gamma=0.9, fused_bwd=bwd)
    model, exp, topo, static = _port_side(config, _contact_frame() if inter_world else None)
    if fused_tiers:
        plans = [getattr(static[0], PLANS[n]) for n in TIER_SETS + (("inter_cluster_world",) if inter_world else ())]
        assert all(p is not None for p in plans)
        if inter_world:
            assert int(static[0].inter_world_mask.sum()) > 0
    trainer = Trainer(model, config, device="cpu")
    trainer.expansion = exp
    tstate = trainer.init_train_state(state=_port_state(inter_world))
    frames = trainer.frames(_frames(TRAIN_FRAMES))
    normal, hyper = _jax_draws(STEP_KEY, frames["world_pos"].shape, exp.hyper_noise_shape(model, frames, static))
    calls = []
    real = fused_block.fused_edge_block
    spy = lambda *a, **kw: calls.append(a[6] is not None and a[0].shape[-2]) or real(*a, **kw)
    fused_block.fused_edge_block = spy
    try:
        loss, norms = trainer.loss_and_grads(tstate, topo, frames, normal=normal, static=static, hyper_normal=hyper)
    finally:
        fused_block.fused_edge_block = real
    fused_sets = 1 + (len(TIER_SETS) + inter_world if fused_tiers else 0) if agg_vjp == "fused" else 0
    assert len(calls) == 2 * fused_sets  # 2 blocks
    params = dict(tstate.model.params.named_parameters())
    wparams = dict(want_grads.named_parameters())
    if dtype == "bfloat16":
        rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        flat = lambda xs: torch.cat([x.float().reshape(-1) for x in xs])
        np.testing.assert_allclose(float(loss), want_loss, rtol=2.0**-8)
        assert rel(flat(p.grad for p in params.values()), flat(wparams[n].detach() for n in params)) <= 2.0**-4
        for name, p in params.items():
            assert rel(p.grad.float(), wparams[name].detach().float()) <= 0.5, name
        return
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for name, p in params.items():
        w = wparams[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()), err_msg=name)
    for name, ns in want_norms.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(getattr(norms[name], f).numpy(), w, rtol=1e-5,
                                       atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=f"{name}.{f}")


# -- the task loop and checkpoints -------------------------------------------------


def test_task_loop_on_the_demo_settings(tmp_path, monkeypatch):
    """``get_task(...).run_iterations()`` and ``get_scalars`` on
    configs/plateCluster_demo.yaml (bf16, 8 clusters, fused) with
    ``fused_tiers`` on, cut to latent 16, 2 blocks and two 8-frame
    trajectories of a 5x6 plate: every forward runs the fused block on the
    mesh set and the three tier sets (each with its plan), the scalars are
    finite, the checkpoint holds the RMP normalizers, and a second task on
    the directory resumes at epoch 1 and trains nothing."""
    config = cut_config("plateCluster_demo")
    params = config["params"]
    params["model"]["compute_dtype"] = "bfloat16"
    params["model"]["rmp"]["fused_tiers"] = True
    params["task"].update(
        batch_size=4, epochs=1, n_timesteps=6, trajectories=2,
        synthetic={"trajectories": 2, "num_steps": 8, "nx": 5, "ny": 6},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": 2},
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
    )
    calls = []
    real = fused_block.fused_edge_block
    monkeypatch.setattr(fused_block, "fused_edge_block",
                        lambda *a, **kw: calls.append((a[0].shape[-2], kw["plan"] is not None)) or real(*a, **kw))
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.run_iterations()
    scalars = task.get_scalars()
    assert len(scalars) == 5 and "test_world_edge_truncated" in scalars  # plate's truncation count
    assert all(np.isfinite(v) for v in scalars.values())
    assert calls and all(planned for _, planned in calls)
    # mesh (98 edges), up and down (39 each: one a node), inter (8 x 7): 4 a block
    assert {E for E, _ in calls} == {98, 39, 56} and len(calls) % 4 == 0
    path = os.path.join(task.out_dir, checkpoint.checkpoint_name(config, 1))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert {"intra_edge", "inter_edge", "hyper_node", "world_edge"} <= set(payload["normalizers"])
    again = get_task(config, data_dir=str(tmp_path), device="cpu")
    assert again.start_epoch == 1
    monkeypatch.setattr(again.simulator, "fit_trajectory", lambda *a, **k: pytest.fail("trained"))
    again.run_iterations()


def test_jax_checkpoint_serves_in_the_port(tmp_path):
    """A JAX plateCluster checkpoint (``.pkl``: the hyper encoder, the
    hierarchical node models, the tier edge models and the RMP
    normalizers) serves in the port, with ``fused_tiers`` on, bit for bit as
    the converted state, and within rtol 1e-5, atol 1e-6 of the JAX
    ``Predictor`` on the same state."""
    from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
    from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer

    jconfig = hgn_config("gather")
    jmodel = jax_get_model(jconfig)
    jts = JaxTrainer(jmodel, jconfig).init_train_state(jax.random.PRNGKey(0))
    path = jax_checkpoint.save(str(tmp_path), jconfig, jts.replace(model=_jax_state()), 1)
    config = hgn_config("fused", True)
    served = Predictor.from_config(config, checkpoint=path, device="cpu")
    assert served.state.params.hyper_encoder is not None
    assert {"intra_edge", "inter_edge", "hyper_node", "world_edge"} <= set(served.state.normalizers)
    batch = {k: v[12:16] for k, v in _traj().items()}
    got = served.one_step(batch)
    assert np.array_equal(got, Predictor(config, state=_port_state(), device="cpu").one_step(batch))
    jp = JaxPredictor(jconfig)
    jp.state = _jax_state()
    np.testing.assert_allclose(got, jp.one_step(batch), rtol=1e-5, atol=1e-6)
