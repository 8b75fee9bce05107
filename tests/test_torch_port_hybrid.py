"""The hybrid fused block (``model.fused_fwd: xla``): the port against the
JAX package.

The JAX side runs ``fused_edge_block_hybrid`` (an XLA forward, then
``_bwd_kernel`` with ``tie_tol`` 2**-8 in bf16 and 1e-5 in float32, in
interpret mode, as tests/test_fused_block.py runs it); the port runs
``ops.fused_block.fused_edge_block_hybrid`` on the CPU, where K2's wrapper
takes its plain version with the same tolerance.  Inputs are drawn with
numpy (``tests/torch_port_cases.py``: an 8x8 grid with a masked tail, B=2,
latent 32); weights go over in the port's layout.  Both take the gradient of
``vdot(e2 * mask, ge2) + vdot(agg, gagg)``.

Tolerances:
- float32: TestHybridParity's (tests/test_fused_block.py:224-283): ``e2``
  and ``agg`` atol 2e-5; edge and node gradients atol 3e-4; weight
  gradients atol 3e-3, rtol 1e-4.  Both forwards are the same unfused chain
  (summation order only), and both backwards route by the same tolerance.
- bf16: ``e2`` and ``agg`` within a relative L2 error of 2**-6 (the two
  forwards round at the same points; measured 0), and each gradient within
  a relative L2 error of 2**-3 (tests/test_torch_port_train.py's bf16
  gradient limit).  JAX's kernel in interpret mode does not recompute its
  forward's bf16 ``e2`` bit for bit (ROADMAP section 3), and at bf16's
  resolution many edges lie within 2**-8 of a maximum, so each package
  routes a different few: measured 3.9e-2 to 6.6e-2, while each package
  reads 2.4e-2 to 9.3e-2 from a float32 run on the same bf16-rounded
  inputs, where the two agree exactly.
- the train step (flag 6x6, 2 blocks, as ``TestFusedTrainParity._run``
  sets it up, latent 32): loss rtol 1e-5 and every gradient within rtol
  1e-4 and atol 1e-5 of its largest element (tests/test_torch_port_train.py's
  float32 limits), against JAX's hybrid step on the same state and noise;
  against the port's own fused (K1/K2) step the loss within 1e-4 of it, as
  ``test_hybrid_fwd_matches_xla`` holds JAX's.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.ops.pallas import fused_block as jax_fb
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import fused_block as fb
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import flag_config, masked_edge_case, tie_edge_case

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
NAMES = ("e", "sp", "rp") + fb.EDGE_WEIGHT_KEYS


def _inputs(arrays, weights, snd, rcv, mask, N, num_valid=None):
    """Both packages' arguments of the hybrid on one case."""
    gidx, gval = receivers_to_gather(rcv, N, mask=mask)
    plan = jax_fb.build_band_plan(snd, rcv, N, num_valid=num_valid, chunk=128)
    jax_args = (snd, rcv, gidx, gval)
    port_args = (torch.tensor(snd), torch.tensor(rcv), torch.tensor(mask), N, torch.tensor(gidx),
                 torch.tensor(gval))
    return plan, jax_args, port_args


def _cotangents(B, E, N, L, mask, seed=9, max_only=False):
    rng = np.random.default_rng(seed)
    ge2 = (rng.normal(size=(B, E, L)) * mask[None, :, None]).astype(np.float32)
    gagg = rng.normal(size=(B, N, 4 * L)).astype(np.float32)
    if max_only:  # the max part alone: the routed cotangent shows in every gradient
        ge2[:] = 0.0
        gagg[..., : 2 * L] = 0.0
        gagg[..., 3 * L :] = 0.0
    return ge2, gagg


def _jax(arrays, weights, plan, jax_args, N, mask, ge2, gagg, dtype):
    """JAX's hybrid: ``e2``, ``agg`` and the gradients (port layout)."""
    jdt = DTYPES[dtype][0]
    snd, rcv, gidx, gval = (jnp.asarray(a) for a in jax_args)

    def loss(e, sp, rp, w):
        e2, agg = jax_fb.fused_edge_block_hybrid(e, sp, rp, w, plan, N, snd, rcv, gidx, gval, interpret=True)
        return jnp.vdot(e2.astype(jnp.float32) * mask[None, :, None], ge2) + jnp.vdot(agg, gagg), (e2, agg)

    args = [jnp.asarray(arrays[k]).astype(jdt) for k in ("e", "sp", "rp")]
    g, (e2, agg) = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *args, {k: jnp.asarray(v) for k, v in weights.items()})
    out = {k: np.asarray(v.astype(jnp.float32)) for k, v in zip(("e", "sp", "rp"), g[:3])}
    out.update({k: np.asarray(v).T if v.ndim == 2 else np.asarray(v) for k, v in g[3].items()})
    return np.asarray(e2.astype(jnp.float32)), np.asarray(agg), out


def _port(arrays, weights, port_args, ge2, gagg, dtype):
    """The port's hybrid: ``e2``, ``agg`` and the gradients."""
    tdt = DTYPES[dtype][1]
    t = [torch.tensor(arrays[k]).to(tdt).requires_grad_() for k in ("e", "sp", "rp")]
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).requires_grad_() for k, v in weights.items()}
    snd, rcv, mask, N, gidx, gval = port_args
    e2, agg = fb.fused_edge_block_hybrid(*t, w, snd, rcv, mask, N, gidx, gval)
    assert type(agg.grad_fn).__name__ == "HybridEdgeBlockBackward"
    loss = (e2.float() * mask[None, :, None] * torch.tensor(ge2)).sum() + (agg * torch.tensor(gagg)).sum()
    grads = torch.autograd.grad(loss, t + [w[k] for k in fb.EDGE_WEIGHT_KEYS])
    return e2.detach().float().numpy(), agg.detach().numpy(), {n: g.float().numpy() for n, g in zip(NAMES, grads)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_block_matches_jax(dtype):
    """One hybrid block: ``e2``, ``agg`` and every gradient, the weights'
    included, against JAX's ``fused_edge_block_hybrid``."""
    arrays, weights, snd, rcv, mask, N, nv = masked_edge_case(seed=3)
    plan, jax_args, port_args = _inputs(arrays, weights, snd, rcv, mask, N, nv)
    B, E, L = arrays["e"].shape
    ge2, gagg = _cotangents(B, E, N, L, mask)
    je2, jagg, jg = _jax(arrays, weights, plan, jax_args, N, mask, ge2, gagg, dtype)
    pe2, pagg, pg = _port(arrays, weights, port_args, ge2, gagg, dtype)
    m = mask[None, :, None]
    outs = [("e2", pe2 * m, je2 * m), ("agg", pagg, jagg)]
    for name in NAMES:
        p, j = pg[name], jg[name]
        outs.append((name, p * m, j * m) if name == "e" else (name, p, j))
    for name, p, j in outs:
        if dtype == "bfloat16":
            limit = 2.0**-6 if name in ("e2", "agg") else 2.0**-3
            assert _rel_l2(p, j) <= limit, (name, _rel_l2(p, j))
        elif name in ("e2", "agg"):
            np.testing.assert_allclose(p, j, atol=2e-5, err_msg=name)
        elif name in ("e", "sp", "rp"):
            np.testing.assert_allclose(p, j, atol=3e-4, err_msg=name)
        else:
            np.testing.assert_allclose(p, j, atol=3e-3, rtol=1e-4, err_msg=name)


def _near_tie_case():
    """tie_edge_case's copied edges (every third receiver's first edge
    twice) with the copy's features moved by 3e-7 relative: its ``e2``
    sits a few float32 units from the original's, inside 1e-5, in most
    columns."""
    arrays, weights, snd, rcv, mask, N, copies = tie_edge_case(seed=5)
    arrays["e"][:, copies] *= np.float32(1 + 3e-7)
    return arrays, weights, snd, rcv, mask, N, copies


def test_near_ties_route_the_same_edges(monkeypatch):
    """Planted near-ties in float32 and only the max cotangent: JAX and the
    port route it to the same edges (every edge within the tolerance of its
    receiver's maximum), so ``de`` agrees on the copies; the exact compare
    (tie_tol 0) leaves many (copy, column) pairs that the tolerance routes."""
    arrays, weights, snd, rcv, mask, N, copies = _near_tie_case()
    plan, jax_args, port_args = _inputs(arrays, weights, snd, rcv, mask, N)
    B, E, L = arrays["e"].shape
    ge2, gagg = _cotangents(B, E, N, L, mask, seed=6, max_only=True)
    _, jagg, jg = _jax(arrays, weights, plan, jax_args, N, mask, ge2, gagg, "float32")
    pe2, pagg, pg = _port(arrays, weights, port_args, ge2, gagg, "float32")
    np.testing.assert_allclose(pg["e"], jg["e"], atol=3e-4)
    np.testing.assert_allclose(pg["e"][:, copies], jg["e"][:, copies], atol=3e-4)
    # the winners each rule picks, on the port's e2
    e2, mx = torch.tensor(pe2), torch.tensor(pagg[..., 2 * L : 3 * L])[:, torch.tensor(rcv).long()]
    tolerant = fb.ties(e2, mx, fb.HYBRID_TIE_TOL[torch.float32])[:, copies]
    exact = fb.ties(e2, mx, 0.0)[:, copies]
    assert int(tolerant.sum()) > int(exact.sum()) + B * len(copies)
    # the exact compare drops the mass the tolerance routes
    monkeypatch.setitem(fb.HYBRID_TIE_TOL, torch.float32, 0.0)
    _, _, pg0 = _port(arrays, weights, port_args, ge2, gagg, "float32")
    assert float(np.abs(pg0["e"][:, copies] - jg["e"][:, copies]).max()) > 1e-2


def test_ties_with_tolerance_zero_is_the_exact_compare():
    """``ties`` at tolerance 0 is ``==`` (K2's result without the hybrid is
    unchanged), and above 0 it takes JAX's ``|e2 - m| <= tol * |m| + tol``."""
    rng = np.random.default_rng(0)
    m = torch.tensor(rng.normal(size=1000).astype(np.float32))
    e2 = m + torch.tensor((rng.normal(size=1000) * 1e-5).astype(np.float32))
    e2[::7] = m[::7]
    assert torch.equal(fb.ties(e2, m, 0.0), e2 == m)
    want = np.abs(e2.numpy() - m.numpy()) <= np.float32(1e-5) * np.abs(m.numpy()) + np.float32(1e-5)
    np.testing.assert_array_equal(fb.ties(e2, m, 1e-5).numpy(), want)


# -- the train step --------------------------------------------------------------


def _train_config(fused_fwd="xla", agg_vjp="fused", **model):
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-3, fused_fwd=fused_fwd, **model)
    return config


@functools.lru_cache(maxsize=None)
def _train_setup():
    """JAX's hybrid step on flag 6x6 (4 frames, 2 blocks): its state, loss,
    gradients and noise draw."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=10, nx=6, ny=6), "world_pos", True)
    jmodel = jax_get_model(_train_config())
    jtopo = jmodel.topology_from_trajectory(traj)
    jstate = jax.jit(jmodel.init_state)(jax.random.PRNGKey(0))  # the trainer's init, traced once
    jframes = {k: jnp.asarray(v[:4]) for k, v in traj.items() if k != "cells"}
    _, nkey, _ = jax.random.split(jax.random.PRNGKey(1), 3)

    def loss_fn(params, normalizers):
        frames = jax_add_noise(jframes, jmodel.field, jmodel.noise_scale, jmodel.noise_gamma, nkey)
        mstate = JModelState(params=params, normalizers=normalizers)
        graph, _, mstate = jmodel.make_graph(mstate, jtopo, frames, True)
        target, mstate = jmodel.get_target(mstate, frames, is_training=True)
        out = jax_batched_forward(jmodel, mstate.params, graph)
        mask = jmodel.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params, jstate.normalizers)
    params = jax.tree.map(np.asarray, jstate.params)
    norms = {n: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS} for n, ns in jstate.normalizers.items()}
    return dict(traj=traj, state=(params, norms), loss=float(loss),
                grads=dict(state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params.named_parameters()),
                normal=torch.from_numpy(np.array(jax.random.normal(nkey, jframes["world_pos"].shape))))


def _port_step(fused_fwd):
    s = _train_setup()
    config = _train_config(fused_fwd)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    topo = model.topology_from_trajectory(s["traj"], device="cpu")
    frames = trainer.frames({k: np.asarray(v[:4]) for k, v in s["traj"].items()})
    ts = trainer.init_train_state(state=state_from_jax_numpy(*s["state"]))
    loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=s["normal"])
    return float(loss), {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}


def test_hybrid_train_step_matches_jax():
    """``Trainer`` with ``fused_fwd: xla`` against JAX's hybrid step (same
    state and noise), and its loss against the port's fused K1/K2 step's."""
    s = _train_setup()
    loss, grads = _port_step("xla")
    np.testing.assert_allclose(loss, s["loss"], rtol=1e-5)
    for name, w in s["grads"].items():
        w = w.detach()
        scale = float(w.abs().max())
        torch.testing.assert_close(grads[name], w, rtol=1e-4, atol=1e-5 * scale, msg=name)
    fused_loss, _ = _port_step("kernel")
    assert abs(loss - fused_loss) < 1e-4 * max(1.0, abs(fused_loss))


def test_ignored_knobs_warn_on_the_hybrid():
    """``fused_bwd: stream`` with ``fused_fwd: xla`` selects the hybrid,
    which runs the remat backward: a warning says the knob is ignored, as
    JAX's ``test_ignored_knobs_warn_on_hybrid_branch`` asks of it."""
    config = _train_config(fused_bwd="stream", message_passing_steps=1)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    traj = _train_setup()["traj"]
    topo = model.topology_from_trajectory(traj, device="cpu")
    frames = trainer.frames({k: np.asarray(v[:2]) for k, v in traj.items()})
    ts = trainer.init_train_state()
    with pytest.warns(UserWarning, match="ignore"):
        ts, loss = trainer.train_step(ts, topo, frames, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(loss))


# -- which edge sets take the hybrid ------------------------------------------------


RMP = {"clustering": "random", "connector": "hyper", "num_clusters": 4, "hyper_noise": 0.005}


def _hybrid_sets_jax(config, traj):
    """The sets JAX's first block sends to ``fused_edge_block_hybrid`` (its
    ``_fused_update_and_agg`` on every fused set of the encoded graph, the
    hybrid itself replaced by a recorder)."""
    from hyper_graph_nets_tpu.core.graph import concat_node_tiers
    from hyper_graph_nets_tpu.nn import blocks as jax_blocks
    from hyper_graph_nets_tpu.nn.meshgraphnet import encoder_apply

    model = jax_get_model(config)
    topo = model.topology_from_trajectory(traj)
    exp = jax_build_expansion(model, config)
    static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    state = model.init_state(jax.random.PRNGKey(0))
    frames = {k: jnp.asarray(v[:1]) for k, v in traj.items() if k != "cells"}
    cfg = model.gnn_config
    seen, real = [], jax_fb.fused_edge_block_hybrid

    def spy(e, sp, rp, w, plan, n, *rest, **kw):
        seen.append(name)
        return e, jnp.zeros(e.shape[:-2] + (n, 4 * e.shape[-1]), jnp.float32)

    def first_block(state):  # traced once: the dispatch runs at trace time
        nonlocal name
        graph, _, state = model.make_graph(state, topo, frames, False)
        graph, state = exp.expand(state, graph, frames, model, is_training=False, static=static)
        graph = encoder_apply(state.params, graph, cfg)
        block = jax.tree.map(lambda x: x[0], state.params["processor"])
        all_nodes = concat_node_tiers(graph)
        for name, es in graph.edge_sets.items():
            eparams = block["edge_models"][name]
            if jax_blocks._fused_eligible(eparams, es, cfg):
                jax_blocks._fused_update_and_agg(eparams, all_nodes, es, cfg, all_nodes.shape[-2])
        return jnp.zeros(())

    name = None
    jax_fb.fused_edge_block_hybrid = spy
    try:
        jax.jit(first_block)(state)
    finally:
        jax_fb.fused_edge_block_hybrid = real
    return sorted(seen)


def _hybrid_sets_port(config, traj):
    """The sets the port's first block sends to ``fused_edge_block_hybrid``
    (``nn.blocks._update_sets`` on every set of the encoded graph, the
    hybrid replaced by a recorder)."""
    from hyper_graph_nets_tpu_torch.nn import blocks
    from hyper_graph_nets_tpu_torch.nn.meshgraphnet import encoder_apply

    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    topo = model.topology_from_trajectory(traj, device="cpu")
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames({k: np.asarray(v[:1]) for k, v in traj.items()})
    state = model.init_state()
    seen, real = [], fb.fused_edge_block_hybrid

    def spy(e, sp, rp, w, snd, rcv, mask, n, *rest, **kw):
        seen.append(next(name for name, es in graph.edge_sets.items() if es.receivers is rcv))
        return e, torch.zeros(e.shape[:-2] + (n, 4 * e.shape[-1]))

    fb.fused_edge_block_hybrid = spy
    try:
        with torch.no_grad():
            graph, _, state = model.make_graph(state, topo, frames, False)
            graph, _ = trainer.expansion.expand(state, graph, frames, model, is_training=False, static=static)
            graph = encoder_apply(state.params, graph, model.gnn_config)
            blocks._update_sets(state.params.blocks[0], graph, tuple(graph.edge_sets), model.gnn_config, {}, {})
    finally:
        fb.fused_edge_block_hybrid = real
    return sorted(seen)


@pytest.mark.parametrize("fused_tiers", [False, True], ids=["tiers_unfused", "fused_tiers"])
def test_hybrid_edge_set_choice_in_a_hierarchical_block(fused_tiers):
    """In an RMP model (flag 10x10, K = 4 random clusters, ``hyper``) both packages send the
    same sets to the hybrid: the mesh set (over N + K rows) and, with
    ``rmp.fused_tiers``, the down set, whose one-per-receiver neighbour
    matrix passes the 4x padding gate; the up and inter sets' matrices fail
    it and run K1/K2."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=3, nx=10, ny=10), "world_pos", True)
    config = _train_config(rmp={**RMP, "fused_tiers": fused_tiers})
    want = ["intra_cluster_to_mesh", "mesh_edges"] if fused_tiers else ["mesh_edges"]
    assert _hybrid_sets_jax(config, traj) == want
    assert _hybrid_sets_port(config, traj) == want
