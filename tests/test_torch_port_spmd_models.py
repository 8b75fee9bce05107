"""The sharded train step and forward on cylinder, plate and HGN plate:
the port on the CPU against its own single-device step and the JAX
package's, on the virtual CPU devices.

Inputs are made with numpy and go through both packages: ``configs/
plate.yaml``, ``plateCluster.yaml`` (K = 4 spectral clusters) and
``cylinder.yaml`` cut to latent 16 and 2 blocks, float32, noise as the files
ship it (``tests/torch_port_models.py``); the same JAX init, its normalizers
accumulated over the trajectory, moved by ``convert.state_from_jax_numpy``;
JAX's field and cluster-mean noise draws handed to the port.  The plate is
5x6, not square (a square quad grid leaves the ``mesh_edge`` normalizer's
``|rel_mesh|`` column without variance, ROADMAP section 3), with
``max_world_edges: 64`` as the JAX package's ``TestShardedPlate``; its
NORMAL and OBSTACLE nodes are moved into a fresh 0.05-wide cube in every
frame, so each frame forms its own world set (29 to 60 of its 64 slots
valid in the frames trained), which lies over every graph rank.  Cylinder runs a 7x5 grid.  The port's ranks run the
kernels' plain versions (``RankGroup(..., device="cpu")``); the JAX reference
is its ``xla`` path (``TestShardedPlate``'s default; no Pallas kernel).

Tolerances (float32, PR 14's: the sharded step sums the data ranks' partial
statistics, the ranks' aggregate partials and the ranks' gradients in rank
order, so it differs from the single-device step in summation order only):

- loss rtol 1e-5; every gradient within rtol 1e-4 and atol 1e-5 of its
  tensor's largest element; normalizer states rtol 1e-5, atol 1e-5 of their
  largest;
- the sharded forward against JAX's ``make_sharded_forward``: rtol 2e-4,
  atol 1e-5 (the JAX test's own), and against the port's single-device
  forward rtol 1e-4, atol 2e-5 (the halo forward's);
- the world sets of a data row's graph ranks: equal, exactly;
- the planted controls must miss the gradient limit (the loss limit too
  where the forward changes): the world arrays cut along axis 0 of their
  frame-major layout (the axis a one-dimensional set is cut on) and one
  graph rank's world-set partials zeroed in the forward.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.core.graph import NodeType
from hyper_graph_nets_tpu_torch.data import synthetic
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.parallel import halo
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import (
    EdgeLayout,
    cut_frame_set,
    make_sharded_forward,
    make_spmd_train_step,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from torch_port_models import ModelPair, NORMALIZER_FIELDS, cut_config

B = 4
FRAMES = slice(2, 2 + B)
STEP_KEY = jax.random.PRNGKey(7)
K = 4
SHAPES = {"2x4": ((2, 4), None), "2x2": ((2, 2), None), "1x4_overlap": ((1, 4), 4)}


def _contact(traj, seed=0, width=0.05):
    """The plate's NORMAL and OBSTACLE nodes moved into a fresh cube of
    ``width`` in every frame (targets too): tens of world edges a frame, a
    different set in each."""
    traj = {k: v.copy() for k, v in traj.items()}
    nt = traj["node_type"][0][:, 0]
    close = (nt == NodeType.NORMAL) | (nt == NodeType.OBSTACLE)
    rng = np.random.RandomState(seed)
    for key in ("world_pos", "target|world_pos"):
        traj[key][:, close] = (width * rng.rand(traj[key].shape[0], int(close.sum()), 3)).astype(np.float32)
    return traj


@functools.lru_cache(maxsize=None)
def _traj(family):
    if family == "cylinder":
        return add_targets(synthetic.cylinder_trajectory(num_steps=8, nx=7, ny=5, seed=1), "velocity", False)
    return _contact(add_targets(synthetic.plate_trajectory(num_steps=8, nx=5, ny=6), "world_pos", False))


class Reference:
    """The JAX ``xla`` path of a config on its trajectory: the state (its
    normalizers, the expansion's too, accumulated over the trajectory) in
    both packages' layouts, and the loss, gradients (in the port's layout)
    and normalizers of its train step at ``STEP_KEY`` on ``FRAMES``, with
    its own noise draws, which the port takes."""

    def __init__(self, name, **model):
        self.model_overrides = model
        traj = _traj("cylinder" if name == "cylinder" else "plate")
        pair = ModelPair(name, traj, "xla", **model)
        jmodel, self.frame0 = pair.jmodel, {k: v[0] for k, v in traj.items()}
        exp = jax_build_expansion(jmodel, pair.jconfig)
        static = None if exp is None else exp.prepare(jmodel, self.frame0, pair.jtopo)
        if exp is not None:  # the expansion's normalizers see the trajectory too

            def accumulated(jstate, frames):
                graph, _, jstate = jmodel.make_graph(jstate, pair.jtopo, frames, True)
                _, jstate = exp.expand(jstate, graph, frames, jmodel, True, key=jax.random.PRNGKey(3), static=static)
                return jmodel.get_target(jstate, frames, True)[1]

            pair.jstate = jax.jit(accumulated)(pair.jstate, pair.jframes())
            pair.state = state_from_jax_numpy(*_numpy_state(pair.jstate))
        self.pair, self.traj, self.exp, self.static = pair, traj, exp, static
        _, nkey, ekey = jax.random.split(STEP_KEY, 3)
        frames = jax_add_noise(pair.jframes(FRAMES), jmodel.field, jmodel.noise_scale, jmodel.noise_gamma, nkey)

        def loss_fn(params, normalizers):
            mstate = JModelState(params=params, normalizers=normalizers)
            g, _, mstate = jmodel.make_graph(mstate, pair.jtopo, frames, True)
            if exp is not None:
                g, mstate = exp.expand(mstate, g, frames, jmodel, is_training=True, key=ekey, static=static)
            target, mstate = jmodel.get_target(mstate, frames, is_training=True)
            out = jax_batched_forward(jmodel, mstate.params, g)
            mask = jmodel.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
            return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

        jstate = pair.jstate
        (loss, norms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params, jstate.normalizers)
        self.loss, self.norms = float(loss), norms
        self.grads = {n: g.detach() for n, g in state_from_jax_numpy(
            jax.tree.map(np.asarray, grads), {}).params.named_parameters()}
        x = pair.jframes(FRAMES)[jmodel.field]
        draw = lambda k, s: torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
        self.normal, self.hyper = draw(nkey, x.shape), None
        if exp is not None:  # the last member's split of the expansion key (training/expansion.py:78-84)
            _, sub = jax.random.split(ekey)
            D = x.shape[-1] + pair.jframes(FRAMES)["mesh_pos"].shape[-1]
            self.hyper = draw(sub, (B, static[-1].assign_mean.shape[0], D))


class Case:
    """The port on ``agg_vjp`` beside its :class:`Reference`: model,
    trainer, topology, prepared static and frames, on the CPU."""

    def __init__(self, name, agg_vjp, ref):
        self.ref = ref
        config = cut_config(name, agg_vjp, **ref.model_overrides)
        self.model = get_model(config)
        self.trainer = Trainer(self.model, config, device="cpu")
        self.topo = self.model.topology_from_trajectory(ref.traj, device="cpu")
        self.static = None if self.trainer.expansion is None else self.trainer.expansion.prepare(
            self.model, ref.frame0, self.topo)
        self.frames = self.trainer.frames({k: np.asarray(v[FRAMES]) for k, v in ref.traj.items()})

    def single(self):
        """The port's single-device loss, gradients and normalizers."""
        ts = self.trainer.init_train_state(state=self.ref.pair.state)
        loss, norms = self.trainer.loss_and_grads(ts, self.topo, self.frames, normal=self.ref.normal,
                                                  static=self.static, hyper_normal=self.ref.hyper)
        return float(loss), _grads(ts.model.params), norms

    def sharded(self, case):
        """The port's sharded loss, gradients and normalizers on a group of
        ``SHAPES[case]``."""
        (D, G), bands = SHAPES[case]
        group = RankGroup(D, G, device="cpu")
        step = make_spmd_train_step(self.trainer, shard_topology(self.topo, group, overlap_bands=bands), group)
        ts = self.trainer.init_train_state(state=self.ref.pair.state)
        loss, norms = step.loss_and_grads(ts, self.frames, normal=self.ref.normal, static=self.static,
                                          hyper_normal=self.ref.hyper)
        return float(loss), _grads(ts.model.params), norms




def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
                   for name, ns in state.normalizers.items()}
    return params, normalizers


@functools.lru_cache(maxsize=None)
def _reference(name, cap=64):
    model = {} if name == "cylinder" else {"max_world_edges": cap}
    if name == "plateCluster":
        model["rmp"] = {**cut_config(name)["params"]["model"]["rmp"], "num_clusters": K}
    return Reference(name, **model)


@functools.lru_cache(maxsize=None)
def _case(name, agg_vjp="fused", cap=64):
    return Case(name, agg_vjp, _reference(name, cap))


@functools.lru_cache(maxsize=None)
def _single(name, agg_vjp="fused", cap=64):
    return _case(name, agg_vjp, cap).single()


def _grads(params):
    return {n: p.grad.clone() for n, p in params.named_parameters()}


def _assert_grads_close(got, want, what):
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-5 * float(w.abs().max()), msg=f"{what}: {name}")


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(getattr(got[name], f).numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}.{f}")


def _assert_matches(result, name, agg_vjp="fused", cap=64, jax_too=True):
    """Against the port's single-device step on the same path and JAX's."""
    loss, grads, norms = result
    ref = _reference(name, cap)
    refs = [_single(name, agg_vjp, cap) + ("port",)]
    if jax_too:
        refs.append((ref.loss, ref.grads, ref.norms, "jax"))
    for want_loss, want_grads, want_norms, what in refs:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=what)
        _assert_grads_close(grads, want_grads, what)
        _assert_normalizers_close(norms, want_norms)


# -- the per-frame layout -----------------------------------------------------------


def test_cut_frame_set_pads_with_the_invalid_slot_and_cuts_the_edge_axis():
    """A per-frame set of 37 edges over 4 graph ranks: padded to 40 with
    sender 0, receiver 0, mask 0 and zero features, each rank's slice the
    contiguous one on the edge axis (the last of the index arrays, the one
    before the width of the features), its sums per-frame plans over the
    set's rows built on the slice, which sum it as ``index_add_`` does."""
    rng = np.random.default_rng(3)
    Bt, W, N, F, G = 3, 37, 11, 5, 4
    snd = torch.tensor(rng.integers(0, N, (Bt, W)), dtype=torch.int32)
    rcv = torch.tensor(np.sort(rng.integers(1, N, (Bt, W)), axis=-1), dtype=torch.int32)
    mask = torch.tensor((rng.random((Bt, W)) > 0.2).astype(np.float32))
    feats = torch.tensor(rng.normal(size=(Bt, W, F)).astype(np.float32)) * mask[..., None]
    es = segment_ops.EdgeSums.per_frame(snd, rcv, mask, N + 2)  # re-rowed: N + K rows
    from hyper_graph_nets_tpu_torch.core.graph import EdgeSet

    whole = EdgeSet(features=feats, senders=snd, receivers=rcv, mask=mask, sums=es)
    parts = [cut_frame_set(whole, G, k) for k in range(G)]
    assert all(p.num_edges == 10 and p.features.shape == (Bt, 10, F) for p in parts)
    cat = lambda f: torch.cat([getattr(p, f) for p in parts], dim=-2 if f == "features" else -1)
    assert torch.equal(cat("senders")[:, :W], snd) and not cat("senders")[:, W:].any()
    assert torch.equal(cat("receivers")[:, :W], rcv) and not cat("receivers")[:, W:].any()
    assert torch.equal(cat("mask")[:, :W], mask) and not cat("mask")[:, W:].any()
    assert torch.equal(cat("features")[:, :W], feats) and not cat("features")[:, W:].any()
    layout = EdgeLayout.build(W, G)
    assert layout.padded == 40 and torch.equal(layout.relay(snd, 0, axis=-1)[:, layout.shard(2)], parts[2].senders)
    total = sum(segment_ops.segment_sum_fixed(p.features, p.sums.receivers) for p in parts)
    assert all(p.sums.receivers.num_segments == N + 2 for p in parts)
    batch = torch.arange(Bt)[:, None].expand(Bt, W)
    want = torch.zeros(Bt, N + 2, F).index_put_((batch, rcv.long()), feats * mask[..., None], accumulate=True)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_aggregate_on_per_frame_receivers_equals_one_device():
    """The sharded aggregate of a per-frame set (``[B, W]`` receivers, each
    rank's slice with its ``FrameSum`` plans) over a 2 x 2 group equals the
    one-device pna of each data row's frames, and its backward the
    one-device backward (``split`` ties: autograd through the scatter; the
    mean's count and the tie counts per frame, over every shard), within
    1e-6; tied values on a grid of 0.5 in every frame."""
    rng = np.random.default_rng(5)
    Bt, W, N, F = 4, 24, 7, 3
    rcv = torch.tensor(np.sort(rng.integers(0, N, (Bt, W)), axis=-1), dtype=torch.int32)
    mask = torch.tensor((rng.random((Bt, W)) > 0.25).astype(np.float32))
    x = torch.tensor(np.round(rng.normal(size=(Bt, W, F)) * 2) / 2, dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(Bt, N, 4 * F)).astype(np.float32))
    group = RankGroup(2, 2, device="cpu")
    b = Bt // 2
    xs, outs_in = [], []
    for r in range(group.n):
        d, g = group.axis_index(r, "data"), group.axis_index(r, "graph")
        sl = slice(g * W // 2, (g + 1) * W // 2)
        xs.append(x[d * b : (d + 1) * b, sl].clone().requires_grad_())
        outs_in.append((rcv[d * b : (d + 1) * b, sl].contiguous(), mask[d * b : (d + 1) * b, sl].contiguous()))

    def rank_fn(r):
        r_rcv, r_mask = outs_in[r]
        sums = segment_ops.FrameSum.build(r_rcv, r_mask, N)
        return segment_ops.sharded_aggregate(xs[r], r_rcv, N, "pna", r_mask, group, sums=sums, ties="split")

    outs = group.run(rank_fn)
    torch.autograd.backward([(outs[group.rank_at(d, 0)] * w[d * b : (d + 1) * b]).sum() for d in range(2)])
    xt = x.clone().requires_grad_()
    want = segment_ops.aggregate(xt, rcv, N, "pna", mask, sums=segment_ops.FrameSum.build(rcv, mask, N))
    (want * w).sum().backward()
    for r in range(group.n):
        d, g = group.axis_index(r, "data"), group.axis_index(r, "graph")
        torch.testing.assert_close(outs[r].detach(), want[d * b : (d + 1) * b].detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(xs[r].grad, xt.grad[d * b : (d + 1) * b, g * W // 2 : (g + 1) * W // 2],
                                   rtol=1e-6, atol=1e-6)


# -- plate ------------------------------------------------------------------------------


def _world_sets(monkeypatch):
    """Record the whole world set each rank cuts (``cut_frame_set``'s input)."""
    seen = {}
    real = halo.cut_frame_set

    def spy(es, graph, k):
        seen.setdefault(k, []).append((es.senders.clone(), es.receivers.clone(), es.mask.clone()))
        return real(es, graph, k)

    monkeypatch.setattr(halo, "cut_frame_set", spy)
    return seen


@pytest.mark.parametrize("agg_vjp", ["fused", "xla"])
def test_sharded_plate_step_matches_single_device_and_jax(agg_vjp, monkeypatch):
    """Plate on a 2 x 4 group (``TestShardedPlate``'s mesh): the mesh set
    through K1 raw and K2 per shard (``fused``, their plain versions) or the
    sharded aggregate (``xla``), the world set built whole by every graph
    rank and cut into per-rank slices with their own sums, against the
    port's single-device step on the same path and JAX's; every graph rank
    of a data row builds the same world set, bit for bit, and the frames'
    world sets lie over every graph rank."""
    seen = _world_sets(monkeypatch)
    c = _case("plate", agg_vjp)
    _assert_matches(c.sharded("2x4"), "plate", agg_vjp)
    assert len(seen) == 4 and all(len(v) == 2 for v in seen.values())  # 2 data rows a graph rank
    for d in range(2):  # the group runs each graph rank's data rows in rank order
        first = seen[0][d]
        assert all(all(torch.equal(a, b) for a, b in zip(seen[g][d], first)) for g in range(1, 4))
        assert first[2].shape[-1] == 64 and not (first[2] > 0).all()
    assert any((seen[0][d][2][:, 48:] > 0).any() for d in range(2))  # the last graph rank's slice


def test_sharded_plate_forward_matches_jax():
    """``make_sharded_forward`` of plate on a 2 x 4 group against JAX's
    ``make_sharded_forward`` on a 2 x 4 mesh and the port's single-device
    forward."""
    c = _case("plate")
    model, topo, pair = c.model, c.topo, c.ref.pair
    group = RankGroup(2, 4, device="cpu")
    got = make_sharded_forward(model, shard_topology(topo, group), group)(pair.state, c.frames).numpy()
    with torch.no_grad():
        graph, _, _ = model.make_graph(pair.state, topo, c.frames, False)
        single = model.forward(pair.state, graph).numpy()
    mesh = jax_sharding.make_mesh(2, 4)
    jfwd = jax_sharding.make_sharded_forward(pair.jmodel, jax_sharding.shard_topology(pair.jtopo, mesh), mesh)
    want = np.asarray(jfwd(jax_sharding.replicate(pair.jstate, mesh),
                           jax_sharding.shard_frames(pair.jframes(FRAMES), mesh)))
    assert got.shape == (B, topo.num_nodes, 3)
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_sharded_plate_pads_a_world_capacity_that_does_not_divide():
    """``max_world_edges: 62`` on 4 graph ranks: the world set pads to 64
    with its invalid slot; the step against the port's single-device step
    and JAX's."""
    c = _case("plate", cap=62)
    assert c.single()[0] > 0
    ws = c.model.frame_features(c.topo, c.frames)["world_senders"]
    assert ws.shape[-1] == 62
    _assert_matches(c.sharded("2x4"), "plate", cap=62)


def test_sharded_sorted_plate_step_matches_single_device():
    """Plate under ``agg_vjp: sorted`` on 2 x 2: the mesh set through K4f/K4b
    (plain) on each data row's joined shards, the world set unfused over its
    per-frame slices, against the port's single-device sorted step and JAX."""
    _assert_matches(_case("plate", "sorted").sharded("2x2"), "plate", "sorted")


def _frame_major_cut(es, graph, k):
    """The control: the world arrays cut along axis 0 of their frame-major
    layout, as a one-dimensional set is cut, the features on their edge
    axis: rank k's edges are the frame-major positions ``[k * bW/G, (k + 1)
    * bW/G)``, so its index arrays belong to other frames than its
    features."""
    per = es.num_edges // graph
    flat = lambda t: t.reshape(-1).narrow(0, k * t.numel() // graph, t.numel() // graph).reshape(
        t.shape[:-1] + (per,)).contiguous()
    snd, rcv, mask = flat(es.senders), flat(es.receivers), flat(es.mask)
    return es.replace(features=es.features.narrow(-2, k * per, per).contiguous(), senders=snd, receivers=rcv,
                      mask=mask, sums=segment_ops.EdgeSums.per_frame(snd, rcv, mask, es.sums.receivers.num_segments))


def _zeroed_world_partials(real):
    """The control: graph rank 0's world-set partials (the set with
    per-frame receivers) zeroed before they combine, in the forward."""

    def combine(entries, group, ties):
        if entries[0]["shard"][0].dim() == 2:
            entries = [dict(e, raw=torch.zeros_like(e["raw"])) if group.axis_index(r, "graph") == 0 else e
                       for r, e in enumerate(entries)]
        return real(entries, group, ties)

    return combine


@pytest.mark.parametrize("control", ["frame_major_cut", "zeroed_partials"])
def test_world_set_controls_miss(control, monkeypatch):
    """Planted faults in the world set's layout and aggregate must miss the
    limits the sound step meets against the port's single-device step."""
    c = _case("plate")
    if control == "frame_major_cut":
        monkeypatch.setattr(halo, "cut_frame_set", _frame_major_cut)
    else:
        monkeypatch.setattr(segment_ops, "_sharded_combine", _zeroed_world_partials(segment_ops._sharded_combine))
    loss, grads, _ = c.sharded("2x4")
    want_loss, want_grads, _ = _single("plate")
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, want_grads, control)


# -- HGN plate and cylinder -------------------------------------------------------------------


def test_sharded_hgn_plate_step_matches_single_device_and_jax():
    """HGN plate (spectral K = 4, ``hyper``, hyper noise) on 2 x 2: the mesh
    set's plans over N + K rows, the tier sets padded and unfused, the world
    set re-rowed over N + K rows and cut after it, with JAX's cluster-mean
    noise; against the port's single-device step and JAX's."""
    c = _case("plateCluster")
    assert c.ref.hyper is not None and c.ref.hyper.shape[-2] == K
    assert tuple(c.ref.hyper.shape) == c.trainer.expansion.hyper_noise_shape(c.model, c.frames, c.static)
    _assert_matches(c.sharded("2x2"), "plateCluster")


@pytest.mark.parametrize("case", ["2x2", "1x4_overlap"])
def test_sharded_cylinder_step_matches_single_device_and_jax(case):
    """Cylinder (its mesh set only, the NORMAL and OUTFLOW loss rows) on 2 x
    2 (K1 raw + K2 per shard) and on 1 x 4 with overlap bands (K7, then K2),
    the kernels' plain versions, against the port's single-device step and
    JAX's."""
    _assert_matches(_case("cylinder").sharded(case), "cylinder")


def test_split_graph_cuts_a_batched_world_set_per_data_rank():
    """``halo.split_graph`` of a batched plate graph on a 2 x 2 group: each
    rank's world set is its data rank's frames, cut on the edge axis for its
    graph rank with its own sums (``cut_frame_set`` of those frames), and
    its mesh set the graph rank's slice of the laid-out edges."""
    c = _case("plate")
    group = RankGroup(2, 2, device="cpu")
    stopo = shard_topology(c.topo, group)
    with torch.no_grad():
        graph, _, _ = c.model.make_graph(c.ref.pair.state, stopo, c.frames, False)
    parts = halo.split_graph(graph, group)
    world = graph.edge_sets["world_edges"]
    for r, part in enumerate(parts):
        d, g = group.axis_index(r, "data"), group.axis_index(r, "graph")
        rows = slice(2 * d, 2 * d + 2)
        mine = world.replace(features=world.features[rows], senders=world.senders[rows],
                             receivers=world.receivers[rows], mask=world.mask[rows])
        want = cut_frame_set(mine, 2, g)
        got = part.edge_sets["world_edges"]
        for f in ("features", "senders", "receivers", "mask"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (r, f)
        assert torch.equal(got.sums.receivers.order, want.sums.receivers.order)
        assert torch.equal(part.node_features, graph.node_features[rows])
        assert part.edge_sets["mesh_edges"].num_edges == len(stopo.senders) // 2


def test_sharded_step_on_an_unknown_model_raises():
    """``check_supported`` takes flag, cylinder and plate (every family of
    both packages); any other model is an unknown-model error."""
    from hyper_graph_nets_tpu_torch.parallel.sharding import check_supported

    check_supported(get_model(cut_config("cylinder")), None)
    with pytest.raises(ValueError, match="Other is not one of them"):
        check_supported(type("Other", (), {})(), None)


def test_sharded_cylinder_step_with_rmp_matches_single_device():
    """Cylinder with RMP ``hyper`` (spectral K = 4, hyper noise), which no
    shipped config sets and ``check_supported`` takes, on 2 x 2: the mesh
    set's plans over N + K rows and the tier sets unfused, against the
    port's single-device step on the same state and noise draws."""
    rmp = {**cut_config("cylinder")["params"]["model"]["rmp"], "clustering": "spectral", "connector": "hyper",
           "num_clusters": K, "hyper_noise": 0.005}
    config = cut_config("cylinder", "fused", rmp=rmp)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    traj = _traj("cylinder")
    topo = model.topology_from_trajectory(traj, device="cpu")
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames({k: np.asarray(v[FRAMES]) for k, v in traj.items()})
    gen = torch.Generator().manual_seed(3)
    normal = torch.randn(frames["velocity"].shape, generator=gen)
    hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static), generator=gen)
    state = model.init_state(torch.Generator().manual_seed(0))
    runs = []
    for group in (None, RankGroup(2, 2, device="cpu")):
        ts = trainer.init_train_state(state=state)
        if group is None:
            loss, norms = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        else:
            step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
            loss, norms = step.loss_and_grads(ts, frames, normal=normal, static=static, hyper_normal=hyper)
        runs.append((float(loss), _grads(ts.model.params), norms))
    (want_loss, want_grads, want_norms), (loss, grads, norms) = runs
    assert static[0].num_clusters == K and any("intra_cluster_to_cluster" in n for n in grads)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_close(grads, want_grads, "cylinder rmp")
    _assert_normalizers_close(norms, want_norms)
