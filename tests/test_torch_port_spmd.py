"""The sharded train step over a data x graph rank group: the port on the
CPU against its own single-device step and the JAX package's, on the
virtual CPU devices.

Same weights (a JAX init moved by ``convert.state_from_jax_numpy``), 4
frames of a 10x10 synthetic flag (522 edges: every shard split puts some
receivers' edges on two ranks), latent 32, 2 blocks, noise 0.003, gamma 0.9,
and JAX's noise draw (``trainer.py:159-163``) handed to the port.  The
port's ranks run the kernels' plain versions (``RankGroup(..., device=
"cpu")``); the JAX side runs its Pallas kernels in interpret mode, its rings
on at most 4 of the 8 virtual devices (``fused_overlap.py:358-365``), with
the interpret state reset around each JAX ring as tests/test_torch_port_halo.py
does.

Tolerances (float32):
- loss rtol 1e-5; every gradient within rtol 1e-4 and atol 1e-5 of its
  largest element; normalizer states rtol 1e-5 (tests/test_torch_port_train.py's:
  summation order only).  The sharded step sums the data ranks' partial
  statistics and the ranks' gradients in rank order, so it differs from the
  single-device step in float32 rounding only.
- the local-degree control (each shard's plans without the global degree,
  the JAX package's ``_plan_degrees`` of the shard) must miss the same
  gradient limit; it matches the JAX package's own sharded gradients within
  it, and those miss JAX's single-device gradients: the standing finding.
- bf16 (one case): loss within 2**-8, gradients by relative L2 norm per
  tensor within 2**-5 of the port's single-device bf16 step (both round to
  bf16 at the same points; the aggregates sum in another order).
- the sharded forward and the 2-D halo forward: float32 within rtol 1e-4 and
  atol 2e-5 (tests/test_torch_port_halo.py's); batched K7 and sub-ring K6
  plain versions against JAX's interpret kernels within 1e-5 and 1e-6.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding, PartitionSpec as P

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.ops.pallas.fused_block import build_sharded_band_plans
from hyper_graph_nets_tpu.ops.pallas.fused_overlap import _mesh_neighbors, _overlap_fwd_call
from hyper_graph_nets_tpu.ops.pallas.fused_block import band_plan_specs
from hyper_graph_nets_tpu.ops.pallas.ring import ring_all_reduce_segments as jax_ring
from hyper_graph_nets_tpu.parallel import halo as jax_halo
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.trainer import (
    Trainer as JaxTrainer,
    add_noise as jax_add_noise,
    batched_forward as jax_batched_forward,
)
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import fused_block as fb
from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph
from hyper_graph_nets_tpu_torch.parallel.sharding import (
    RankPlans,
    make_sharded_forward,
    make_spmd_train_step,
    shard_frames,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import flag_config

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
SHAPES = {"2x2": ((2, 2), None), "1x4": ((1, 4), None), "2x1": ((2, 1), None), "1x4_overlap": ((1, 4), 4)}
NX = 13
B = 4


def _reset():
    pltpu.reset_tpu_interpret_mode_state()
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    _reset()
    yield


def _config(dtype=None, agg_vjp="fused"):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    return config


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


@functools.lru_cache(maxsize=None)
def _setup(dtype=None):
    """The JAX model, trainer state, topology and frames; the port's model,
    trainer, state (converted), topology and frames; JAX's noise draw."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)
    config = _config(dtype)
    jmodel = jax_get_model(config)
    jtrainer = JaxTrainer(jmodel, config)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0))
    jtopo = jmodel.topology_from_trajectory(traj)
    # normalizers accumulated over the whole trajectory first: a fresh one
    # standardizes the step's own few frames, whose near-constant columns
    # (the flag starts flat) turn float32 rounding into gradient differences
    # of 1e-3 between the port and JAX on one device already
    every = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    _, _, mstate = jmodel.make_graph(jstate.model, jtopo, every, True)
    _, mstate = jmodel.get_target(mstate, every, True)
    jstate = jstate.replace(model=mstate)
    jframes = {k: jnp.asarray(v[:B]) for k, v in traj.items() if k != "cells"}
    _, nkey, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    return dict(
        traj=traj, jmodel=jmodel, jstate=jstate, jframes=jframes, nkey=nkey,
        jtopo=jtopo,
        normal=torch.tensor(np.array(jax.random.normal(nkey, jframes["world_pos"].shape))),
        model=model, trainer=trainer, topo=model.topology_from_trajectory(traj, device="cpu"),
        frames=trainer.frames({k: np.array(v) for k, v in jframes.items()}),
        numpy_state=_numpy_state(jstate.model),
    )


def _port_state(s):
    return s["trainer"].init_train_state(state=state_from_jax_numpy(*s["numpy_state"]))


def _grads(params):
    return {n: p.grad.clone() for n, p in params.named_parameters()}


@functools.lru_cache(maxsize=None)
def _single_device(dtype=None):
    """The port's single-device loss, gradients and normalizers."""
    s = _setup(dtype)
    ts = _port_state(s)
    loss, norms = s["trainer"].loss_and_grads(ts, s["topo"], s["frames"], normal=s["normal"])
    return float(loss), _grads(ts.model.params), norms


def _jax_loss_and_grads(s, cfg=None, topo=None, mesh=None):
    """JAX's loss, gradients (in the port's layout) and normalizers: its
    single-device ``loss_fn`` (``trainer.py:143-156``), or with ``cfg``,
    ``topo`` and ``mesh`` the sharded step's (``sharding.py:258-275``)."""
    model = s["jmodel"]
    topo = s["jtopo"] if topo is None else topo
    frames = jax_add_noise(s["jframes"], model.field, model.noise_scale, model.noise_gamma, s["nkey"])
    if mesh is not None:
        frames = jax_sharding.shard_frames(frames, mesh)

    def loss_fn(params, normalizers):
        mstate = JModelState(params=params, normalizers=normalizers)
        graph, _, mstate = model.make_graph(mstate, topo, frames, True)
        target, mstate = model.get_target(mstate, frames, is_training=True)
        if mesh is None:
            out = jax_batched_forward(model, mstate.params, graph)
        else:
            out = jax_sharding._batched_forward_cfg(cfg, mstate.params, jax_sharding.constrain_graph(graph, mesh))
        mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        loss = jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1])
        return loss, mstate.normalizers

    (loss, norms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        s["jstate"].model.params, s["jstate"].model.normalizers
    )
    grads = dict(state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params.named_parameters())
    return float(loss), {n: g.detach() for n, g in grads.items()}, norms


@functools.lru_cache(maxsize=None)
def _jax_single():
    return _jax_loss_and_grads(_setup())


def _sharded(shape, bands, degree=True, dtype=None):
    """The port's sharded loss, gradients and normalizers; ``degree=False``
    plants the local-degree control (the plans without the global degree)."""
    s = _setup(dtype)
    group = RankGroup(*shape, device="cpu")
    stopo = shard_topology(s["topo"], group, overlap_bands=bands)
    if not degree:
        plans = tuple(dataclasses.replace(p, degree=None) for p in stopo.plan.plans)
        stopo = stopo._replace(plan=RankPlans(plans))
    ts = _port_state(s)
    loss, norms = make_spmd_train_step(s["trainer"], stopo, group).loss_and_grads(ts, s["frames"], normal=s["normal"])
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


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["2x2", "1x4", "1x4_overlap"])
def test_shard_topology_and_frames_match_jax(case):
    """The same edges, padding and mask on every rank as JAX's
    ``shard_topology`` on a (data, graph) mesh, the same frames as
    ``P('data')`` puts on each device, each rank's plan over its graph
    rank's slice with the global in-degree."""
    (D, G), bands = SHAPES[case]
    s = _setup()
    mesh = jax_sharding.make_mesh(D, G)
    jst = jax_sharding.shard_topology(s["jtopo"], mesh, overlap_bands=bands)
    group = RankGroup(D, G, device="cpu")
    st = shard_topology(s["topo"], group, overlap_bands=bands)
    for a, b in ((st.senders, jst.senders), (st.receivers, jst.receivers), (st.mask, jst.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    per = len(st.senders) // G
    degree = np.bincount(s["topo"].receivers.numpy(), minlength=NX * NX)
    assert isinstance(st.plan, RankPlans) and len(st.plan.plans) == D * G
    for r, plan in enumerate(st.plan.plans):
        g = group.coords(r)[1]
        assert plan.num_edges == per and plan.overlap_bands == (bands or 0)
        assert plan is st.plan.plans[group.rank_at(0, g)]  # built once per graph rank
        np.testing.assert_array_equal(plan.degree.numpy(), degree)
    jframes = jax_sharding.shard_frames(s["jframes"], mesh)
    ours = shard_frames(s["frames"], group)
    devices = np.asarray(mesh.devices).reshape(-1)
    for key in ("world_pos", "node_type"):
        by_device = {sh.device: np.asarray(sh.data) for sh in jframes[key].addressable_shards}
        for r in range(D * G):
            np.testing.assert_array_equal(ours[r][key].numpy(), by_device[devices[r]])


def test_split_graph_of_a_batch_gives_each_rank_its_frames_and_edges():
    """A batched graph split over a 2 x 2 group: rank (d, g) gets data rank
    d's frames (as ``shard_frames``) and graph rank g's edges, plan and sums
    (as ``shard_graph``), on storage of its own."""
    from hyper_graph_nets_tpu_torch.parallel.halo import shard_graph

    s = _setup()
    group = RankGroup(2, 2, device="cpu")
    stopo = shard_topology(s["topo"], group)
    state = _port_state(s).model
    with torch.no_grad():
        graph, _, _ = s["model"].make_graph(state, stopo, s["frames"], False)
    parts = split_graph(graph, group)
    for r, part in enumerate(parts):
        d, g = group.coords(r)
        want = shard_graph(graph, group, r)
        es, ws = part.edge_sets["mesh_edges"], want.edge_sets["mesh_edges"]
        assert torch.equal(part.node_features, graph.node_features[2 * d : 2 * d + 2])
        assert torch.equal(es.features, ws.features[2 * d : 2 * d + 2])
        assert torch.equal(es.receivers, ws.receivers) and es.plan is stopo.plan.plans[r]
        assert es.sums is stopo.sums.sums[r] and es.features.data_ptr() != ws.features.data_ptr()
        assert es.features.shape[-2] == len(stopo.senders) // 2


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_ring_neighbours_match_jax_mesh_neighbors(shape):
    """Rank r's left and right neighbours along ``graph`` of a 2-D group are
    JAX's ``_mesh_neighbors`` ids on a mesh of that shape (the ``data``
    coordinate fixed; on 4 x 1 every rank is its own neighbour); a 1-D group
    keeps its ring over every rank."""
    mesh = jax_sharding.make_mesh(*shape)
    axes = tuple((a, mesh.shape[a]) for a in mesh.axis_names)

    def body(x):
        left, right = _mesh_neighbors("graph", axes)
        return jnp.stack([left, right]).reshape(1, 1, 2) + 0 * x

    got = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data", "graph"),
                                out_specs=P("data", "graph"), check_vma=False))(jnp.zeros((*shape, 2), jnp.int32))
    want = np.asarray(got).reshape(4, 2)
    group = RankGroup(*shape, device="cpu")
    for r in range(4):
        assert (group.left(r), group.right(r)) == tuple(want[r])
    line = RankGroup(4, device="cpu")
    assert [line.right(r) for r in range(4)] == [1, 2, 3, 0] and line.shape == {"data": 1, "graph": 4}


# -- the sharded step -------------------------------------------------------------


@pytest.mark.parametrize("case", list(SHAPES))
def test_sharded_step_matches_single_device(case):
    """Loss, gradients and normalizers of the port's sharded step against
    the port's and JAX's single-device steps, on the same state and noise."""
    shape, bands = SHAPES[case]
    loss, grads, norms = _sharded(shape, bands)
    for want_loss, want_grads, want_norms, what in (_single_device() + ("port",), _jax_single() + ("jax",)):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=what)
        _assert_grads_close(grads, want_grads, what)
        _assert_normalizers_close(norms, want_norms)


@pytest.mark.parametrize("case", ["2x2", "1x4", "1x4_overlap"])
def test_local_degree_control_misses_the_gradients(case):
    """The planted control: each shard's own in-degree in the mean
    cotangent (the JAX package's sharded backward) misses the single-device
    gradients, while its loss stays right (the forward is the same)."""
    shape, bands = SHAPES[case]
    loss, grads, _ = _sharded(shape, bands, degree=False)
    want_loss, want_grads, _ = _single_device()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, want_grads, "local degree")


def test_jax_sharded_gradients_differ_in_the_mean_part():
    """The standing finding (ROADMAP section 3): JAX's sharded step divides
    the mean cotangent by each shard's own in-degree, so its gradients miss
    its own single-device ones; the port's local-degree control reproduces
    them within the same limit, so the degree is the whole difference."""
    s = _setup()
    mesh = jax_sharding.make_mesh(1, 4)
    jst = jax_sharding.shard_topology(s["jtopo"], mesh)
    cfg = jax_sharding.spmd_gnn_config(s["jmodel"], jst, mesh)
    loss, grads, _ = _jax_loss_and_grads(s, cfg, jst, mesh)
    jloss, jgrads, _ = _jax_single()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, jgrads, "jax sharded")
    _, control, _ = _sharded((1, 4), None, degree=False)
    _assert_grads_close(control, grads, "control vs jax sharded")


def test_sharded_step_bfloat16():
    loss, grads, _ = _sharded((2, 2), None, dtype="bfloat16")
    want_loss, want_grads, _ = _single_device("bfloat16")
    assert abs(loss - want_loss) <= 2.0**-8 * abs(want_loss)
    for name, w in want_grads.items():
        rel = float((grads[name] - w).norm() / w.norm().clamp(min=1e-30))
        assert rel <= 2.0**-5, (name, rel)


def test_sharded_steps_repeat_bit_for_bit_and_update_every_device():
    """Two steps from one state give the same loss, gradients and
    parameters bit for bit; the update is Adam's on the summed gradients,
    the single-device step's within float32 rounding."""
    s = _setup()
    group = RankGroup(2, 2, device="cpu")
    step = make_spmd_train_step(s["trainer"], shard_topology(s["topo"], group), group)
    runs = []
    for _ in range(2):
        ts = _port_state(s)
        ts2, loss = step(ts, s["frames"], normal=s["normal"])
        runs.append((loss, [p.detach().clone() for p in ts2.model.params.parameters()], ts2.step))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][2] == 1
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    ts = _port_state(s)
    single, _ = s["trainer"].train_step(ts, s["topo"], s["frames"], normal=s["normal"])
    for a, b in zip(runs[0][1], single.model.params.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=1e-6)


def test_sharded_step_raises_on_what_it_does_not_run():
    """What raised before the expansions were ported now runs (an
    expansion, the Ricci balancer, ``agg_vjp: xla``, a masked topology),
    each step's loss the single-device step's, and so does a group over
    several devices; a batch that does not split over the data ranks still
    raises.  tests/test_torch_port_spmd_expansion.py holds the gradients."""
    from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

    s = _setup()
    group = RankGroup(2, 2, device="cpu")
    frame0 = {k: v[0] for k, v in s["traj"].items()}

    def runs(config, topo=None):
        model = get_model(config)
        trainer = Trainer(model, config, device="cpu")
        topo = model.topology_from_trajectory(s["traj"], device="cpu") if topo is None else topo
        exp = build_expansion(model, config)
        static = None if exp is None else exp.prepare(model, frame0, topo)
        ts = _port_state(s) if exp is None else trainer.init_train_state()
        gen = lambda: torch.Generator().manual_seed(3)
        want, _ = trainer.loss_and_grads(ts, topo, s["frames"], generator=gen(), static=static)
        step = make_spmd_train_step(trainer, shard_topology(topo, group), group, expansion=exp)
        loss, _ = step.loss_and_grads(ts, s["frames"], generator=gen(), static=static)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        assert all(p.grad is not None for p in ts.model.params.parameters() if p.requires_grad)

    rmp = _config()
    rmp["params"]["model"]["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": 4,
                                     "hyper_noise": 0.005, "frequency": 1}
    runs(rmp)
    balanced = _config()
    balanced["params"]["model"]["graph_balancer"].update(algorithm="ricci", ricci={"loops": 5, "tau": 150})
    runs(balanced)
    runs(_config(agg_vjp="xla"))
    masked = s["topo"]._replace(mask=torch.ones(len(s["topo"].senders)).index_fill_(0, torch.tensor([3]), 0.0))
    runs(_config(), topo=masked)
    # a group over two devices, as over two cards, runs too (a parameter copy
    # on the second; tests/test_torch_port_spmd_cards.py holds its gradients)
    spread = RankGroup(2, 2, devices=[torch.device("cpu", d) for d in (0, 0, 1, 1)])
    step = make_spmd_train_step(s["trainer"], shard_topology(s["topo"], spread), spread)
    loss, _ = step.loss_and_grads(_port_state(s), s["frames"], normal=s["normal"])
    np.testing.assert_allclose(float(loss), _single_device()[0], rtol=1e-5)
    with pytest.raises(ValueError, match="data ranks"):
        shard_frames({k: v[:3] for k, v in s["frames"].items()}, group)


# -- the sharded forward and the 2-D halo forward ----------------------------------


def test_sharded_forward_matches_jax():
    s = _setup()
    mesh = jax_sharding.make_mesh(2, 2)
    jst = jax_sharding.shard_topology(s["jtopo"], mesh)
    jfwd = jax_sharding.make_sharded_forward(s["jmodel"], jst, mesh)
    group = RankGroup(2, 2, device="cpu")
    fwd = make_sharded_forward(s["model"], shard_topology(s["topo"], group), group)
    state = _port_state(s).model
    got = fwd(state, s["frames"]).numpy()
    with torch.no_grad():
        graph, _, _ = s["model"].make_graph(state, s["topo"], s["frames"], False)
        single = s["model"].forward(state, graph).numpy()
    want = np.asarray(jfwd(s["jstate"].model, jax_sharding.shard_frames(s["jframes"], mesh)))
    assert got.shape == (B, NX * NX, 3)
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


PATHS = {"fused": ("fused", False, False), "ring": ("xla", True, False), "overlap": ("fused", False, True)}


@pytest.mark.parametrize("path", list(PATHS))
def test_halo_forward_on_a_2d_group_matches_jax(path):
    """The halo forward over a 2 x 2 group (rings along ``graph``, each data
    row the same frame) against JAX's ``make_halo_forward`` on a 2 x 2 mesh
    and the port's single-device forward, on every rank."""
    agg_vjp, ring, overlap = PATHS[path]
    s = _setup()
    config = _config(agg_vjp=agg_vjp)
    jmodel, model = jax_get_model(config), get_model(config)
    bands = 4 if overlap else None
    mesh = jax_sharding.make_mesh(2, 2)
    jst = jax_sharding.shard_topology(jmodel.topology_from_trajectory(s["traj"]), mesh, overlap_bands=bands)
    frame_np = {k: v[0] for k, v in s["traj"].items() if k != "cells"}
    jgraph, _, _ = jmodel.make_graph(s["jstate"].model, jst, {k: jnp.asarray(v) for k, v in frame_np.items()},
                                     False, batched=False)
    group = RankGroup(2, 2, device="cpu")
    state = _port_state(s).model
    topo = model.topology_from_trajectory(s["traj"], device="cpu")
    frame = {k: torch.as_tensor(v) for k, v in frame_np.items()}
    with torch.no_grad():
        graph, _, _ = model.make_graph(state, shard_topology(topo, group, overlap_bands=bands), frame, False)
        single_graph, _, _ = model.make_graph(state, topo, frame, False)
        single = model.forward(state, single_graph).numpy()
    outs = make_halo_forward(model, group, ring=ring, overlap=overlap)(state, split_graph(graph, group),
                                                                       all_ranks=True)
    for o in outs:
        np.testing.assert_allclose(o.numpy(), single, rtol=1e-4, atol=2e-5)
    jfwd = jax_halo.make_halo_forward(jmodel, mesh, ring=ring, overlap=overlap)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jfwd(s["jstate"].model.params, jgraph)),
                               rtol=1e-4, atol=2e-5)


# -- the kernels' new modes --------------------------------------------------------


def _torch_weights(weights):
    return {k: torch.tensor(v.T.copy() if v.ndim == 2 else v) for k, v in weights.items()}


def test_batched_k7_plain_matches_jax_overlap_call():
    """K7 on B = 2 frames: each frame rings on its own, as the JAX kernel's
    grid (B, G) does; every rank's aggregate against JAX's, e2 against the
    port's K1 on the same shard exactly."""
    S, E_per, N, L, Bk = 2, 64, 96, 32, 2
    rng = np.random.RandomState(3)
    E = E_per * S
    rcv = np.sort(rng.randint(0, N, E)).astype(np.int32)
    snd = np.clip(rcv + rng.randint(-8, 9, E), 0, N - 1).astype(np.int32)
    ev = E - 8
    rcv[ev:], snd[ev:] = N - 1, N - 1
    mask = (np.arange(E) < ev).astype(np.float32)
    plan = build_sharded_band_plans(snd, rcv, N, S, num_valid=ev, chunk=32, overlap_bands=4)
    e = rng.randn(Bk, E, L).astype(np.float32)
    sp, rp = (rng.randn(Bk, N, L).astype(np.float32) for _ in range(2))
    w = {k: (rng.randn(L, L) * 0.1).astype(np.float32) for k in ("we", "w2", "w3")}
    w.update({k: (rng.randn(L) * 0.1).astype(np.float32) for k in ("b1", "b2", "b3", "lnb")})
    w["lns"] = (rng.randn(L) * 0.1 + 1).astype(np.float32)

    def body(e_l, sp_l, rp_l, w_l, p_l):
        from hyper_graph_nets_tpu.ops.pallas.fused_block import _edge_weights

        e2, agg = _overlap_fwd_call(e_l, sp_l, rp_l, _edge_weights(w_l), p_l, N, "graph", True)
        return e2[:, : e_l.shape[1]], agg[:, :N]

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]), ("graph",))
    sm = jax.shard_map(body, mesh=mesh, in_specs=(P(None, "graph"), P(), P(), P(), band_plan_specs(P, plan)),
                       out_specs=(P(None, "graph"), P()), check_vma=False)
    je2, jagg = (np.asarray(o) for o in jax.jit(sm)(e, sp, rp, w, plan))
    tw = _torch_weights(w)
    shards = [
        dict(e=torch.tensor(e[:, r * E_per : (r + 1) * E_per]), sp=torch.tensor(sp), rp=torch.tensor(rp),
             weights=tw, senders=torch.tensor(snd[r * E_per : (r + 1) * E_per]),
             receivers=torch.tensor(rcv[r * E_per : (r + 1) * E_per]),
             mask=torch.tensor(mask[r * E_per : (r + 1) * E_per]))
        for r in range(S)
    ]
    got = fused_edge_block_overlap(shards, N, RankGroup(S, device="cpu"), bands=4)
    for r, x in enumerate(shards):
        e2, _ = fb.fused_edge_block_reference(x["e"], x["sp"], x["rp"], tw, x["senders"], x["receivers"],
                                              x["mask"], N)
        assert torch.equal(got[r][0], e2) and got[r][1].shape == (Bk, N, 4 * L)
        valid = mask[r * E_per : (r + 1) * E_per] > 0
        np.testing.assert_allclose(got[r][0].numpy()[:, valid], je2[:, r * E_per : (r + 1) * E_per][:, valid],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[r][1].numpy(), jagg, rtol=1e-5, atol=1e-5)
        for b in range(Bk):  # frame b alone gives frame b's aggregate
            one = fused_edge_block_overlap([dict(x2, e=x2["e"][b], sp=x2["sp"][b], rp=x2["rp"][b])
                                            for x2 in shards], N, RankGroup(S, device="cpu"), bands=4)
            assert torch.equal(one[r][1], got[r][1][b])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_subring_k6_plain_matches_jax_ring_with_mesh_axes(shape):
    """K6 along ``graph`` of a 2-D group against JAX's ring with
    ``mesh_axes`` on a mesh of that shape: each sub-ring folds its own
    ranks."""
    R, C = 6, 8
    x = np.random.RandomState(11).randn(4, 3 * R, C).astype(np.float32)
    segments = [(0, R, "sum"), (R, 2 * R, "max"), (2 * R, 3 * R, "min")]
    group = RankGroup(*shape, device="cpu")
    got = ring_all_reduce_segments([torch.tensor(x[r]) for r in range(4)], segments, group)
    mesh = jax_sharding.make_mesh(*shape)
    axes = tuple((a, mesh.shape[a]) for a in mesh.axis_names)
    fn = jax.shard_map(lambda v: jax_ring(v[0, 0], segments, "graph", mesh_axes=axes)[None, None], mesh=mesh,
                       in_specs=P("data", "graph"), out_specs=P("data", "graph"), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x.reshape(*shape, 3 * R, C)))).reshape(4, 3 * R, C)
    for r in range(4):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-6, atol=1e-6)
    for ranks in group.subgroups("graph"):  # the sub-ring's own ranks only
        np.testing.assert_allclose(got[ranks[0]][R : 2 * R].numpy(), np.max([x[r][R : 2 * R] for r in ranks], 0))
