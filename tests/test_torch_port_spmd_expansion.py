"""The sharded train step with an expansion (remote message passing, the
Ricci balancer) and with unfused edge sets under autograd: the port on the
CPU against its own single-device step and the JAX package's.

The port's ranks run the kernels' plain versions (``RankGroup(..., device=
"cpu")``).  Same weights (a JAX init whose normalizers, the expansion's
included, have seen the whole trajectory, moved by
``convert.state_from_jax_numpy``), 4 frames of a 10x10 synthetic flag (522
mesh edges: every split puts some receivers' edges on two ranks, and 4
ranks pad them to 524), latent 32, 2 blocks, noise 0.003, gamma 0.9; RMP
spectral into K = 4 clusters with the ``hyper`` connector and hyper noise
0.005; JAX's field and cluster-mean noise draws handed to the port.  The
JAX reference is its single-device ``gather`` path (no Pallas kernel: the
fused path's results on one device are the same up to summation order, and
JAX's fused path aggregates the edges the balancer removed, a standing
finding, ROADMAP section 3).

Tolerances (float32, tests/test_torch_port_spmd.py's, summation order only:
the sharded step sums the data ranks' partial statistics, the ranks'
aggregate partials and the ranks' gradients in rank order):
- loss rtol 1e-5; every gradient within rtol 1e-4 and atol 1e-5 of its
  largest element; normalizer states rtol 1e-5, atol 1e-5 of their largest;
- the sharded forward within rtol 1e-4 and atol 2e-5 (the halo forward's);
- the planted controls must miss the gradient limit: the balancer's plans
  with the in-degree of the unmasked topology (every removed edge counted
  in the mean), and, on tie-heavy data, the ``split`` tie rule counting
  one shard's ties in place of every shard's (the global count is the
  one-device result);
- bf16 (one case): loss within 2**-8, gradients by relative L2 norm per
  tensor within 2**-5 of the port's single-device bf16 step (both round to
  bf16 at the same points; the aggregates sum in another order).
"""
import contextlib
import dataclasses
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
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import (
    EdgeLayout,
    RankPlans,
    ShardedStatic,
    make_sharded_forward,
    make_spmd_train_step,
    shard_static,
    shard_topology,
    with_degree,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import flag_config

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
SHAPES = {"2x2": ((2, 2), None), "1x4": ((1, 4), None), "1x4_overlap": ((1, 4), 4)}
NX, B, K = 10, 4, 4
STEP_KEY = 11
RICCI = {"algorithm": "ricci", "remove_edges": True, "frequency": 1, "ricci": {"loops": 10, "tau": 150}}


def _config(agg_vjp="fused", rmp=True, balancer=False, dtype=None):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    model = config["params"]["model"]
    model.update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    if rmp:
        model["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": K,
                        "hyper_noise": 0.005, "hyper_node_features": True, "frequency": 1}
    if balancer:
        model["graph_balancer"] = dict(RICCI)
    return config


@functools.lru_cache(maxsize=None)
def _traj():
    return jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)


def _frame0():
    return {k: v[0] for k, v in _traj().items()}


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


@functools.lru_cache(maxsize=None)
def _jax_side(rmp=True, balancer=False):
    """JAX's ``gather`` model, expansion, topology and static; a state whose
    normalizers have seen the trajectory; its single-device loss, gradients
    (in the port's layout) and normalizers at ``STEP_KEY`` with its own
    noise draws, and those draws."""
    config = _config("gather", rmp, balancer)
    model = jax_get_model(config)
    traj = _traj()
    topo = model.topology_from_trajectory(traj)
    exp = jax_build_expansion(model, config)
    static = None if exp is None else exp.prepare(model, _frame0(), topo)
    state = model.init_state(jax.random.PRNGKey(0))
    every = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    graph, _, state = model.make_graph(state, topo, every, True)
    if exp is not None:
        _, state = exp.expand(state, graph, every, model, True, key=jax.random.PRNGKey(3), static=static)
    _, state = model.get_target(state, every, True)

    step_key = jax.random.PRNGKey(STEP_KEY)
    _, nkey, ekey = jax.random.split(step_key, 3)
    frames = {k: jnp.asarray(v[:B]) for k, v in traj.items() if k != "cells"}
    frames = jax_add_noise(frames, model.field, model.noise_scale, model.noise_gamma, nkey)

    def loss_fn(params, normalizers):
        mstate = JModelState(params=params, normalizers=normalizers)
        g, _, mstate = model.make_graph(mstate, topo, frames, True)
        if exp is not None:
            g, mstate = exp.expand(mstate, g, frames, model, is_training=True, key=ekey, static=static)
        target, mstate = model.get_target(mstate, frames, is_training=True)
        out = jax_batched_forward(model, mstate.params, g)
        mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, norms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params, state.normalizers)
    grads = dict(state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params.named_parameters())
    normal = torch.from_numpy(np.array(jax.random.normal(nkey, frames["world_pos"].shape, jnp.float32)))
    hyper = None
    if rmp:  # the last member's split of the expansion key (training/expansion.py:78-84)
        for _ in range(1 + balancer):
            ekey, sub = jax.random.split(ekey)
        D = traj["world_pos"].shape[-1] + traj["mesh_pos"].shape[-1]
        hyper = torch.from_numpy(np.array(jax.random.normal(sub, (B, static[-1].assign_mean.shape[0], D),
                                                            jnp.float32)))
    return dict(model=model, topo=topo, exp=exp, static=static, state=state, numpy_state=_numpy_state(state),
                loss=float(loss), grads={n: g.detach() for n, g in grads.items()}, norms=norms,
                normal=normal, hyper=hyper)


@functools.lru_cache(maxsize=None)
def _port(agg_vjp="fused", rmp=True, balancer=False, dtype=None):
    """The port's model, trainer, topology, prepared static and frames."""
    config = _config(agg_vjp, rmp, balancer, dtype)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    topo = model.topology_from_trajectory(_traj(), device="cpu")
    static = None if trainer.expansion is None else trainer.expansion.prepare(model, _frame0(), topo)
    frames = trainer.frames({k: v[:B] for k, v in _traj().items()})
    return model, trainer, topo, static, frames


def _state(trainer, rmp, balancer):
    return trainer.init_train_state(state=state_from_jax_numpy(*_jax_side(rmp, balancer)["numpy_state"]))


def _grads(params):
    return {n: p.grad.clone() for n, p in params.named_parameters()}


@functools.lru_cache(maxsize=None)
def _single(agg_vjp="fused", rmp=True, balancer=False, dtype=None):
    """The port's single-device loss, gradients and normalizers."""
    model, trainer, topo, static, frames = _port(agg_vjp, rmp, balancer, dtype)
    j = _jax_side(rmp, balancer)
    ts = _state(trainer, rmp, balancer)
    loss, norms = trainer.loss_and_grads(ts, topo, frames, normal=j["normal"], static=static,
                                         hyper_normal=j["hyper"])
    return float(loss), _grads(ts.model.params), norms


def _sharded(case, agg_vjp="fused", rmp=True, balancer=False, dtype=None, plant=None, masked_topo=None):
    """The port's sharded loss, gradients and normalizers; ``plant(sstatic)
    -> sstatic`` plants a control in the laid-out static."""
    (D, G), bands = SHAPES[case]
    model, trainer, topo, static, frames = _port(agg_vjp, rmp, balancer, dtype)
    j = _jax_side(rmp, balancer)
    group = RankGroup(D, G, device="cpu")
    stopo = shard_topology(topo if masked_topo is None else masked_topo, group, overlap_bands=bands)
    step = make_spmd_train_step(trainer, stopo, group)
    if plant is not None:
        static = plant(shard_static(trainer.expansion, static, stopo, group))
    ts = _state(trainer, rmp, balancer)
    loss, norms = step.loss_and_grads(ts, frames, normal=j["normal"], static=static, hyper_normal=j["hyper"])
    return float(loss), _grads(ts.model.params), norms


def _assert_grads_close(got, want, what):
    for name, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-5 * scale, msg=f"{what}: {name}")


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(
                getattr(got[name], f).numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                err_msg=f"{name}.{f}",
            )


def _assert_matches(result, rmp, balancer, agg_vjp="fused", jax_too=True):
    """Against the port's single-device step on the same path and JAX's."""
    loss, grads, norms = result
    j = _jax_side(rmp, balancer)
    refs = [_single(agg_vjp, rmp, balancer) + ("port",)]
    if jax_too:
        refs.append((j["loss"], j["grads"], j["norms"], "jax"))
    for want_loss, want_grads, want_norms, what in refs:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=what)
        _assert_grads_close(grads, want_grads, what)
        _assert_normalizers_close(norms, want_norms)


# -- the layout ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 8], ids=["contiguous", "round_robin"])
def test_edge_layout_relays_every_per_edge_array_with_its_edge(chunk):
    """A layout pads and deals any per-edge array as the edges themselves
    (numpy and torch alike, along any axis), and re-points edge ids at
    where their edges lie."""
    layout = EdgeLayout.build(45, 3, chunk)
    assert layout.padded % (3 * (chunk or 1)) == 0 and layout.padded >= 45
    ids = np.arange(45)
    laid = layout.relay(ids, -1)
    assert (laid == -1).sum() == layout.padded - 45
    feats = torch.arange(2 * 45 * 2).reshape(2, 45, 2)
    laid_t = layout.relay(feats, 0, axis=1)
    for pos in np.flatnonzero(laid >= 0):
        assert torch.equal(laid_t[:, pos], feats[:, laid[pos]])
    np.testing.assert_array_equal(laid[layout.relay_ids(ids)], ids)
    assert torch.equal(layout.relay_ids(torch.from_numpy(ids)), torch.from_numpy(layout.relay_ids(ids)))


def test_shard_topology_carries_the_mask_and_counts_valid_edges():
    """A masked topology (every seventh edge masked, inside receivers'
    segments) shards with its mask on its edges, and the plans' in-degree
    counts valid edges only (JAX's ``shard_topology`` drops the mask,
    ROADMAP section 3)."""
    _, _, topo, _, _ = _port(rmp=False)
    mask = torch.ones(len(topo.senders))
    mask[3::7] = 0.0
    masked = topo._replace(mask=mask)
    group = RankGroup(1, 4, device="cpu")
    for bands in (None, 4):
        st = shard_topology(masked, group, overlap_bands=bands)
        valid = st.mask.numpy() > 0
        assert int(valid.sum()) == int(mask.sum())
        np.testing.assert_array_equal(st.mask.numpy(), st.layout.relay(mask.numpy(), 0.0))
        degree = np.bincount(st.receivers.numpy()[valid], minlength=NX * NX)
        for plan in st.plan.plans:
            np.testing.assert_array_equal(plan.degree.numpy(), degree)


# -- the sharded step with remote message passing --------------------------------


@pytest.mark.parametrize("case", list(SHAPES))
def test_sharded_rmp_step_matches_single_device(case):
    """RMP ``hyper`` (fused mesh set over N + K rows: K1 raw or K7 and K2
    per shard, the three tier sets unfused through the sharded aggregate)
    against the port's single-device step and JAX's, same state and noise."""
    _assert_matches(_sharded(case), rmp=True, balancer=False)


def test_sharded_rmp_forward_matches_jax():
    """``make_sharded_forward`` with RMP on a 2 x 2 group against JAX's
    ``make_sharded_forward`` on a 2 x 2 mesh and the port's single-device
    forward."""
    j = _jax_side(True, False)
    model, trainer, topo, static, frames = _port()
    group = RankGroup(2, 2, device="cpu")
    fwd = make_sharded_forward(model, shard_topology(topo, group), group, expansion=trainer.expansion)
    state = _state(trainer, True, False).model
    got = fwd(state, frames, static=static).numpy()
    with torch.no_grad():
        graph, _, _ = model.make_graph(state, topo, frames, False)
        graph, _ = trainer.expansion.expand(state, graph, frames, model, is_training=False, static=static)
        single = model.forward(state, graph).numpy()
    mesh = jax_sharding.make_mesh(2, 2)
    jfwd = jax_sharding.make_sharded_forward(j["model"], jax_sharding.shard_topology(j["topo"], mesh), mesh,
                                             expansion=j["exp"])
    jframes = jax_sharding.shard_frames({k: jnp.asarray(v[:B]) for k, v in _traj().items() if k != "cells"}, mesh)
    want = np.asarray(jfwd(jax_sharding.replicate(j["state"], mesh), jframes, j["static"]))
    assert got.shape == (B, NX * NX, 3)
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_sharded_rmp_step_bfloat16():
    loss, grads, _ = _sharded("2x2", dtype="bfloat16")
    want_loss, want_grads, _ = _single(dtype="bfloat16")
    assert abs(loss - want_loss) <= 2.0**-8 * abs(want_loss)
    for name, w in want_grads.items():
        rel = float((grads[name] - w).norm() / w.norm().clamp(min=1e-30))
        assert rel <= 2.0**-5, (name, rel)


def test_the_static_is_laid_out_once_per_prepare():
    """A caller lays each prepare's static out once with ``shard_static``
    (the per-rank sums and plans rebuilt on the host), and the step takes
    the result as it is; given the prepared static (or none: the
    expansion's cached one), the step lays it out on each call, the same
    sums and plans."""
    model, trainer, topo, static, frames = _port()
    group = RankGroup(2, 2, device="cpu")
    stopo = shard_topology(topo, group)
    step = make_spmd_train_step(trainer, stopo, group)
    first = shard_static(trainer.expansion, static, stopo, group)
    assert step.laid_out(first) is first
    rmp = first.members[0]
    assert rmp.up_plan is None and isinstance(rmp.mesh_plan, RankPlans)
    assert rmp.mesh_plan.plans[0].num_nodes == NX * NX + rmp.num_clusters
    assert len(rmp.up_sums.sums) == group.n and rmp.up_senders.shape[0] % 2 == 0
    for again in (step.laid_out(static), step.laid_out(None)):
        assert again is not first
        for k, sums in enumerate(again.members[0].up_sums.sums):
            assert torch.equal(sums.receivers.ids, first.members[0].up_sums.sums[k].receivers.ids)
        assert torch.equal(again.members[0].mesh_plan.plans[0].degree, rmp.mesh_plan.plans[0].degree)
    # with rmp.fused_tiers the unsharded static plans the tier sets; laid out, they run unfused
    config = _config()
    config["params"]["model"]["rmp"]["fused_tiers"] = True
    fmodel = get_model(config)
    ftrainer = Trainer(fmodel, config, device="cpu")
    fstatic = ftrainer.expansion.prepare(fmodel, _frame0(), topo)
    assert any(getattr(fstatic[0], f"{t}_plan") is not None for t in ("up", "down", "inter"))
    laid = make_spmd_train_step(ftrainer, shard_topology(topo, group), group).laid_out(fstatic).members[0]
    assert all(getattr(laid, f"{t}_plan") is None for t in ("up", "down", "inter"))


def test_what_the_sharded_step_does_not_run_raises_naming_the_item():
    """A group over several devices (entry 7.3, once raising naming ROADMAP
    queue 1, item 7) runs with an expansion, its loss the one-device
    group's (rtol 1e-5); a model configured with an expansion needs it
    given to the forward.  Every connector and architecture of RMP and the graph
    balancer on every family build (they run in
    tests/test_torch_port_spmd_arch.py)."""
    from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

    group = RankGroup(2, 2, device="cpu")
    _, trainer, topo, static, frames = _port()
    stopo = shard_topology(topo, group)
    runs = []
    for pair in (RankGroup(2, devices=["cpu:0", "cpu:1"]), RankGroup(2, device="cpu")):
        step = make_spmd_train_step(trainer, shard_topology(topo, pair), pair)
        loss, _ = step.loss_and_grads(trainer.init_train_state(), frames, generator=torch.Generator().manual_seed(3),
                                      static=static)
        runs.append(float(loss))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    with pytest.raises(ValueError, match="build_expansion"):
        make_sharded_forward(get_model(_config()), stopo, group)
    config = _config()
    config["params"]["model"]["rmp"]["connector"] = "multiscale"
    model = get_model(config)
    make_spmd_train_step(Trainer(model, config, device="cpu"), stopo, group)
    cylinder = {"params": {"task": {"dataset": "cylinder_flow"},
                           "model": {**flag_config(None)["params"]["model"], "field": "velocity", "history": False,
                                     "size": 2, "noise": 0.02, "gamma": 1.0, "graph_balancer": dict(RICCI)}}}
    cmodel = get_model(cylinder)
    make_sharded_forward(cmodel, stopo, group, expansion=build_expansion(cmodel, cylinder))


# -- the balancer -------------------------------------------------------------------


def _unmasked_degree(sstatic: ShardedStatic) -> ShardedStatic:
    """The planted control: every mesh plan's in-degree from the unmasked
    topology (the removed edges counted)."""
    topo = sstatic.topo
    plant = lambda plans: with_degree(plans, torch.from_numpy(np.bincount(
        topo.receivers.numpy()[topo.mask.numpy() > 0], minlength=plans.plans[0].num_nodes).astype(np.float32)))
    members = tuple(m._replace(mesh_plan=plant(m.mesh_plan)) if getattr(m, "mesh_plan", None) is not None else m
                    for m in sstatic.members)
    return ShardedStatic(topo=topo._replace(plan=plant(topo.plan)), members=members)


@pytest.mark.parametrize("case, rmp", [("2x2", False), ("1x4_overlap", False), ("2x2", True)],
                         ids=["2x2", "1x4_overlap", "2x2+rmp"])
def test_sharded_balancer_step_matches_single_device_and_the_degree_control_misses(case, rmp):
    """The Ricci balancer (SDRF on the unsharded topology, the removed mesh
    edges interior masks on every shard, the balance set sharded and
    unfused), alone and before RMP, against the port's single-device step
    and JAX's ``gather`` path (with RMP JAX's loss and normalizers only: its
    float32 gradients there jump at a near tie, float32 conditioning,
    :func:`test_ricci_before_rmp_gap_to_jax_is_float32_conditioning`);
    the plans' in-degree counts the kept edges, and the same step with the
    unmasked topology's degree must miss."""
    static = _port(rmp=rmp, balancer=True)[3]
    assert float(static[0].mesh_keep.sum()) < len(static[0].mesh_keep)  # edges were removed
    result = _sharded(case, rmp=rmp, balancer=True)
    _assert_matches(result, rmp=rmp, balancer=True, jax_too=not rmp)
    if rmp:
        j = _jax_side(True, True)
        np.testing.assert_allclose(result[0], j["loss"], rtol=1e-5, err_msg="jax")
        _assert_normalizers_close(result[2], j["norms"])
    loss, grads, _ = _sharded(case, rmp=rmp, balancer=True, plant=_unmasked_degree)
    want_loss, want_grads, _ = _single(rmp=rmp, balancer=True)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)  # the forward is the same
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, want_grads, "unmasked degree")


@contextlib.contextmanager
def _port_in_float64():
    """The port's float32 read as float64 (its explicit casts, its
    reductions' float32 among them) and float64 the default dtype."""
    saved = torch.float32
    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32 = saved
        torch.set_default_dtype(saved)


def _float64_single():
    """The port's single-device ``gather`` step with ricci before RMP in
    float64: JAX's float32 state, inputs, static and noise draws widened."""
    _, trainer, topo, static, frames = _port("gather", True, True)
    j = _jax_side(True, True)
    wide = lambda t: t.double() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
    widened = lambda nt: nt._replace(**{f: wide(getattr(nt, f)) for f in nt._fields})
    with _port_in_float64():
        ts = _state(trainer, True, True)
        ts.model.params.double()
        ts = dataclasses.replace(ts, model=ts.model.replace(
            normalizers={k: v.to(torch.float64) for k, v in ts.model.normalizers.items()}))
        loss, _ = trainer.loss_and_grads(ts, widened(topo), {k: wide(v) for k, v in frames.items()},
                                         normal=wide(j["normal"]), static=tuple(widened(s) for s in static),
                                         hyper_normal=wide(j["hyper"]))
        assert all(p.grad.dtype == torch.float64 for p in ts.model.params.parameters())
        return float(loss), _grads(ts.model.params)


UP_ENCODER = "edge_encoders.intra_cluster_to_cluster.weights.0"


def test_ricci_before_rmp_gap_to_jax_is_float32_conditioning():
    """ROADMAP section 3's gap with the Ricci balancer before RMP (10 SDRF
    loops, hyper noise and hyper node features, 2 blocks): the up set's
    edge encoder, whose float32 gradient jumps at a near tie.  Read against
    the port's float64 step (both packages in float64 agree to 3.7e-8
    relative L2, the JAX side by ``jax_enable_x64`` with its float32 read
    as float64, in a probe): JAX's float32 gradient of that tensor lies
    5e-4 to 5e-3 from it (1.14e-3; its ``xla`` path the same), farther than
    any other tensor of JAX's (the up set's edge models and the hyper
    encoder follow, 3e-4 to 7e-4), and moving the port's own float32 input by a
    rounding (1e-7 relative, seeded) makes the port's float32 gradient jump
    as far on the same tensor (4 of 8 seeds do; the unmoved port reads
    5.4e-6).  Neither side is at fault: the gap is float32 conditioning, and
    no limit is tightened for it."""
    loss64, grads64 = _float64_single()
    want = {n: g.float() for n, g in grads64.items()}
    rel = lambda got, n=UP_ENCODER: float((got[n] - want[n]).norm() / want[n].norm())
    j = _jax_side(True, True)
    np.testing.assert_allclose(j["loss"], loss64, rtol=1e-5)
    assert 5e-4 < rel(j["grads"]) < 5e-3
    assert max(want, key=lambda n: rel(j["grads"], n)) == UP_ENCODER
    _, trainer, topo, static, frames = _port("gather", True, True)
    moved = dict(frames)
    moved["world_pos"] = frames["world_pos"] * (1 + 1e-7 * torch.randn(
        frames["world_pos"].shape, generator=torch.Generator().manual_seed(2)))
    ts = _state(trainer, True, True)
    loss, _ = trainer.loss_and_grads(ts, topo, moved, normal=j["normal"], static=static, hyper_normal=j["hyper"])
    np.testing.assert_allclose(float(loss), loss64, rtol=1e-5)
    assert 5e-4 < rel(_grads(ts.model.params)) < 5e-3


class _RemovesEveryHundredthEdge:
    """A balancing algorithm for the JAX ``GraphBalancer``: adds one pair,
    removes every hundredth mesh edge (both directions)."""

    def run(self, topo):
        snd, rcv = np.asarray(topo.senders), np.asarray(topo.receivers)
        return ({"senders": [0], "receivers": [2]},
                {"senders": snd[::100].tolist(), "receivers": rcv[::100].tolist()})


def test_jax_sharded_balancer_mask_is_in_the_unsharded_order():
    """A standing finding, read in the code and shown here: the JAX
    package's ``GraphBalancer.expand`` (``balancer/base.py:141-149``)
    multiplies the sharded mesh mask by ``keep``, which is in the unsharded
    edge order.  The 10x10 flag's 522 edges pad to 524 over 4 ranks, and the
    product fails on its shapes; on the round-robin layout of an 11 x 75
    flag (4,608 edges, no padding over 2 ranks of 256-edge chunks) it
    removes other edges than the balancer chose."""
    from hyper_graph_nets_tpu.balancer.base import GraphBalancer as JaxGraphBalancer

    model = jax_get_model(_config("fused", rmp=False))
    for nx, ny, (D, G), bands in ((NX, NX, (1, 4), None), (11, 75, (1, 2), 4)):
        traj = jax_add_targets(jax_flag_trajectory(num_steps=3, nx=nx, ny=ny), "world_pos", True)
        topo = model.topology_from_trajectory(traj)
        balancer = JaxGraphBalancer(_RemovesEveryHundredthEdge(), capacity=8)
        static = balancer.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        mesh = jax_sharding.make_mesh(D, G)
        st = jax_sharding.shard_topology(topo, mesh, overlap_bands=bands)
        state = model.init_state(jax.random.PRNGKey(0))
        frames = {k: jnp.asarray(v[:1]) for k, v in traj.items() if k != "cells"}
        graph, _, state = model.make_graph(state, st, frames, False)
        expand = lambda: balancer.expand(state, graph, frames, model, is_training=False, static=static)
        if bands is None:
            assert len(st.senders) != len(topo.senders)
            with pytest.raises((TypeError, ValueError)):
                expand()
            continue
        assert len(st.senders) == len(topo.senders) and st.band_plan is not None  # round-robin, no padding
        mask = np.asarray(expand()[0].edge_sets["mesh_edges"].mask)[0]
        removed = lambda s, r, m: {(int(a), int(b)) for a, b, k in zip(s, r, m) if k == 0}
        chosen = removed(topo.senders, topo.receivers, static.mesh_keep)
        got = removed(np.asarray(st.senders), np.asarray(st.receivers), mask)
        assert len(chosen) == len(got) > 0 and got != chosen


# -- unfused mesh sets: sorted, gather, xla -----------------------------------------


@pytest.mark.parametrize("agg_vjp", ["sorted", "gather", "xla"])
def test_sharded_step_on_unfused_paths_matches_single_device(agg_vjp):
    """The flat config under ``sorted``, ``gather`` and ``xla`` on both
    layouts: the mesh set through K4f/K4b on each data row's joined shards
    (``sorted``) or the sharded aggregate, against the port's single-device
    step on the same path (K4f/K4b plain, ``pna_gather``, autograd) and
    JAX's."""
    for case in ("2x2", "1x4"):
        _assert_matches(_sharded(case, agg_vjp, rmp=False), rmp=False, balancer=False, agg_vjp=agg_vjp)


@pytest.mark.parametrize("rmp", [False, True], ids=["flat", "rmp"])
def test_sharded_sorted_step_runs_k4f_and_k4b_once_per_data_row_and_block(rmp, monkeypatch):
    """Under ``sorted`` the sharded step sends the mesh set to the sorted
    pna (K4f forward, K4b backward; here their plain versions) once per data
    row and block, on the joined shards, as the JAX package's sharded step
    runs its sorted kernel on the gathered set; no mesh set reaches the
    sharded aggregate.  With RMP the hierarchical block's mesh sub-step
    takes the same path, against the port's single-device step."""
    from hyper_graph_nets_tpu_torch.ops import segment_pna

    calls = {"fwd": [], "bwd": 0, "agg": []}
    fwd, bwd, agg = segment_pna._forward, segment_pna.pna_sorted_bwd, segment_ops.sharded_aggregate

    def counted_fwd(data, *args):
        calls["fwd"].append(data.shape[-2])
        return fwd(data, *args)

    def counted_bwd(*args):
        calls["bwd"] += 1
        return bwd(*args)

    def counted_agg(data, *args, **kwargs):
        calls["agg"].append(data.shape[-2])
        return agg(data, *args, **kwargs)

    monkeypatch.setattr(segment_pna, "_forward", counted_fwd)
    monkeypatch.setattr(segment_pna, "pna_sorted_bwd", counted_bwd)
    monkeypatch.setattr("hyper_graph_nets_tpu_torch.nn.blocks.sharded_aggregate", counted_agg)
    result = _sharded("2x2", "sorted", rmp=rmp)
    E = len(_port("sorted", rmp=rmp)[2].senders)
    blocks = 2
    assert calls["fwd"] == [E] * (2 * blocks) and calls["bwd"] == 2 * blocks  # E = 522, even: no padding
    assert E not in calls["agg"] and E // 2 not in calls["agg"]
    loss, grads, _ = result
    want_loss, want_grads, _ = _single("sorted", rmp=rmp)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_close(grads, want_grads, "sorted")


def test_pna_sorted_sharded_equals_the_sorted_pna_of_the_joined_edges():
    """On a 2 x 2 group, each data row's shards (interior masks, a masked
    tail, tied values) aggregate to exactly the plain K4f of the joined
    edges, on every rank of the row, and the backward hands each shard
    exactly its slice of the plain K4b's edge cotangent, from the ranks'
    cotangents summed in rank order (values on a grid of 0.5: every sum
    exact)."""
    from hyper_graph_nets_tpu_torch.ops.segment_pna import (
        pna_sorted_bwd_reference,
        pna_sorted_reference,
        pna_sorted_sharded,
        sorted_plan,
    )

    x, rcv, mask, N = _tie_case(E=96)
    mask[-3:] = 0.0
    plan = sorted_plan(rcv, N, mask)
    group = RankGroup(2, 2, device="cpu")
    per = len(rcv) // 2
    rows = [torch.tensor(x + d, requires_grad=True) for d in range(2)]  # each data row's frames
    shard = lambda t, k: t.narrow(1 if t.dim() == 3 else 0, k * per, per)  # along the edges
    xs = [shard(rows[group.axis_index(r, "data")], group.axis_index(r, "graph")).detach().requires_grad_()
          for r in range(group.n)]
    rcv_t, mask_t = torch.from_numpy(rcv), torch.from_numpy(mask)
    outs = group.run(lambda r: pna_sorted_sharded(xs[r], shard(rcv_t, group.axis_index(r, "graph")).clone(),
                                                  shard(mask_t, group.axis_index(r, "graph")).clone(), N, plan,
                                                  group))
    ws = [torch.from_numpy(np.round(np.random.RandomState(r).randn(*outs[r].shape) * 2) / 2).float()
          for r in range(group.n)]
    torch.autograd.backward([(o * w).sum() for o, w in zip(outs, ws)])
    for d in range(2):
        ranks = [group.rank_at(d, g) for g in range(2)]
        want = pna_sorted_reference(rows[d].detach(), rcv_t, mask_t, N)
        g = ws[ranks[0]] + ws[ranks[1]]
        want_ge = pna_sorted_bwd_reference(g, want, rows[d].detach(), rcv_t, mask_t, N)
        for k, r in enumerate(ranks):
            assert torch.equal(outs[r].detach(), want)
            assert torch.equal(xs[r].grad, shard(want_ge, k))


def _tie_case(seed=5, shards=4, E=96, N=12, F=6, Bt=2):
    """Edge features with ties in every receiver (values on a grid of 0.5),
    every receiver's edges split over the shards."""
    rng = np.random.RandomState(seed)
    rcv = np.sort(rng.randint(0, N - 1, E)).astype(np.int32)
    x = (np.round(rng.randn(Bt, E, F) * 2) / 2).astype(np.float32)
    mask = np.ones(E, np.float32)
    mask[5::9] = 0.0
    return x, rcv, mask, N


def _sharded_tie_grads(x, rcv, mask, N, ties, shards=4):
    group = RankGroup(1, shards, device="cpu")
    per = len(rcv) // shards
    xs = [torch.tensor(x[:, k * per : (k + 1) * per], requires_grad=True) for k in range(shards)]
    seg = lambda a, k: torch.tensor(a[k * per : (k + 1) * per])
    w = torch.from_numpy(np.random.RandomState(9).randn(x.shape[0], N, 4 * x.shape[-1]).astype(np.float32))
    outs = group.run(lambda r: segment_ops.sharded_aggregate(xs[r], seg(rcv, r), N, "pna", seg(mask, r), group,
                                                             ties=ties))
    (outs[0] * w).sum().backward()
    return outs[0], torch.cat([t.grad for t in xs], dim=1), w


@pytest.mark.parametrize("ties", ["split", "full"])
def test_sharded_aggregate_routes_ties_as_one_device_and_the_local_count_control_misses(ties, monkeypatch):
    """On tie-heavy data the sharded aggregate and its backward equal the
    one-device aggregate the rule stands for: ``split`` autograd through
    ``gather_aggregate`` (the ``xla`` path: ties share the cotangent, over
    every shard), ``full`` ``pna_gather`` (every tied edge gets all of it).
    The planted control for ``split``: the count of one shard's ties (the
    first's) in place of every shard's."""
    from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather

    x, rcv, mask, N = _tie_case()
    out, grad, w = _sharded_tie_grads(x, rcv, mask, N, ties)
    gidx, gval = (torch.from_numpy(np.asarray(a)) for a in receivers_to_gather(rcv, N, mask=mask))
    xt = torch.tensor(x, requires_grad=True)
    if ties == "split":
        want = segment_ops.gather_aggregate(xt, gidx, gval, "pna")
    else:
        want = segment_ops.pna_gather(xt, gidx, gval, torch.from_numpy(rcv), torch.from_numpy(mask))
    (want * w).sum().backward()
    torch.testing.assert_close(out, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad, xt.grad, rtol=1e-6, atol=1e-6)
    if ties == "split":
        kept = segment_ops._tie_counts

        def local(xs, shards, mx, mn):  # the first shard's ties only
            return kept(xs[:1], shards[:1], mx, mn)

        monkeypatch.setattr(segment_ops, "_tie_counts", local)
        _, control, _ = _sharded_tie_grads(x, rcv, mask, N, ties)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(control, xt.grad, rtol=1e-4, atol=1e-5)


# -- a masked topology ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["2x2", "1x4_overlap"])
def test_sharded_step_on_a_masked_topology_matches_single_device(case):
    """A topology with masked edges inside receivers' segments shards with
    its mask (the plans' degree counting valid edges): the sharded step
    equals the port's single-device step on the same masked topology."""
    model, trainer, topo, _, frames = _port(rmp=False)
    mask = torch.ones(len(topo.senders))
    mask[3::7] = 0.0
    masked = topo._replace(mask=mask)
    j = _jax_side(False, False)
    ts = _state(trainer, False, False)
    want_loss, _ = trainer.loss_and_grads(ts, masked, frames, normal=j["normal"])
    want = _grads(ts.model.params)
    loss, grads, _ = _sharded(case, rmp=False, masked_topo=masked)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    _assert_grads_close(grads, want, "masked topology")
    _, unmasked, _ = _single(rmp=False)
    with pytest.raises(AssertionError):  # the mask is seen
        _assert_grads_close(grads, unmasked, "unmasked")
