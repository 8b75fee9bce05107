"""The Ricci graph balancer (SDRF) and K5: the port against the JAX package.

K5 (``ops/maxprod.py``) runs its plain version on the CPU; the JAX side
runs its Pallas ``maxprod`` in interpret mode and its ``maxprod_reference``.
Curvature, post-delta and the SDRF loop run in both packages on the same
numpy graphs; the balancer's statics and its expansion on the same frames.
Serving and training take a balancing built by hand (added edges and
interior removed mesh edges spread through the mesh), given to both
packages' real ``GraphBalancer``, so neither runs SDRF there.  Weights are a
JAX init moved by ``convert.state_from_jax_numpy``; training noise is JAX's
draw (tests/test_torch_port_train.py).

The port's contract under removal is the JAX ``gather`` (and ``xla``)
result: a removed mesh edge reaches no aggregate on any path.  Two JAX paths
do otherwise (ROADMAP section 3): ``fused`` ignores the removal, and
``sorted`` mis-aggregates an interior mask.  The port's four paths are held
against JAX ``gather``, and ``xla`` also against JAX ``xla``.

Tolerances:
- K5, curvature, post-delta: bit for bit (each product one rounded
  multiply, max exact; the curvature's elementwise steps are the JAX
  function's, in its order, on exact integer counts).  SDRF: the same added
  and removed lists.
- Statics: equal.  ``expand``: features and normalizer states float32
  rtol = 1e-6 (the same operations; only the summation order of the
  normalizer's sums may differ).
- Serving, float32: positions rtol = 1e-5, atol = 1e-6, and the predicted
  acceleration within 1e-5 of its largest magnitude.  bf16: the acceleration
  within 5% of its largest magnitude (test_torch_port_model.py).
- Training, float32: loss rtol = 1e-5; each gradient rtol = 1e-4 and
  atol = 1e-5 of its largest element; normalizer states rtol = 1e-5
  (test_torch_port_train.py).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.balancer.base import (
    GraphBalancer as JGraphBalancer,
    get_balancer as jax_get_balancer,
)
from hyper_graph_nets_tpu.balancer.ricci import (
    balanced_forman_curvature as jax_curvature,
    balanced_forman_post_delta as jax_post_delta,
    sdrf as jax_sdrf,
)
from hyper_graph_nets_tpu.core import segment_ops as jax_segment_ops
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.ops.pallas.maxprod import (
    maxprod as jax_maxprod,
    maxprod_reference as jax_maxprod_reference,
)
from hyper_graph_nets_tpu.ops.pallas.segment_pna import pna_sorted as jax_pna_sorted
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import (
    Trainer as JaxTrainer,
    add_noise as jax_add_noise,
    batched_forward as jax_batched_forward,
)
from hyper_graph_nets_tpu_torch.balancer.base import BalancerStatic, get_balancer
from hyper_graph_nets_tpu_torch.balancer.ricci import (
    balanced_forman_curvature,
    balanced_forman_post_delta,
    sdrf,
)
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.models.base import reset_due
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block
from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod, maxprod_reference
from hyper_graph_nets_tpu_torch.ops.segment_pna import pna_sorted, sorted_plan
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from test_torch_port_model import _numpy_state, _trajectory
from test_torch_port_train import _assert_normalizers_close
from torch_port_cases import flag_config, grid_edges

PATHS = ("xla", "gather", "sorted", "fused")


# -- K5 ----------------------------------------------------------------------


def test_maxprod_matches_jax_bit_for_bit():
    """At 130 x 257 x 190 (no side a multiple of 128), with zeros in both
    inputs: the plain K5 equals JAX's Pallas kernel (interpret mode) and
    JAX's plain version bit for bit, and launches nothing on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.random((130, 257)).astype(np.float32) * (rng.random((130, 257)) > 0.3)
    y = rng.random((257, 190)).astype(np.float32) * (rng.random((257, 190)) > 0.3)
    x[5] = 0.0  # a row whose products are all 0
    before = maxprod.launches
    got = maxprod(torch.tensor(x), torch.tensor(y)).numpy()
    assert maxprod.launches == before
    np.testing.assert_array_equal(got, np.asarray(jax_maxprod(jnp.asarray(x), jnp.asarray(y), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_maxprod_reference(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(got, np.maximum(np.max(x[:, :, None] * y[None], axis=1), 0))
    np.testing.assert_array_equal(maxprod_reference(torch.tensor(x), torch.tensor(y), block=64).numpy(), got)


# -- curvature and post-delta --------------------------------------------------


def _adjacency(kind, seed=0):
    if kind == "flag6":
        snd, rcv, N = grid_edges(6, 6)
        A = np.zeros((N, N), np.float32)
        A[snd, rcv] = 1.0
        return A
    rng = np.random.RandomState(seed)
    A = (rng.rand(24, 24) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    return A


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1), ("flag6", 0)])
def test_curvature_and_post_delta_match_jax(kind, seed):
    A = _adjacency(kind, seed)
    want = np.asarray(jax_curvature(jnp.asarray(A)))
    got = balanced_forman_curvature(torch.tensor(A)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3  # not a trivial curvature
    x, y = divmod(int(np.argmin(np.where(A > 0, want, np.inf))), len(A))  # the most negative edge
    A2 = A @ A
    i_nbrs = np.r_[np.nonzero(A[x])[0], x, -1, -1].astype(np.int32)
    j_nbrs = np.r_[np.nonzero(A[y])[0], y, -1].astype(np.int32)
    jd = jax_post_delta(
        jnp.asarray(A), jnp.asarray(A2), jnp.int32(x), jnp.int32(y), jnp.asarray(i_nbrs), jnp.asarray(j_nbrs)
    )
    d = balanced_forman_post_delta(
        torch.tensor(A), torch.tensor(A2), x, y, torch.tensor(i_nbrs), torch.tensor(j_nbrs)
    )
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (d.numpy() == -1000).any() and (d.numpy() != -1000).any()


# -- SDRF ----------------------------------------------------------------------


def _undirected(pairs):
    snd = np.asarray([a for a, b in pairs] + [b for a, b in pairs], np.int32)
    rcv = np.asarray([b for a, b in pairs] + [a for a, b in pairs], np.int32)
    return snd, rcv


def _sdrf_graph(name):
    """(senders, receivers, num_nodes, sdrf kwargs)."""
    if name == "star_bridge":  # tests/test_balancer.py: two hubs joined by a bridge
        pairs = [(0, 1)] + [(0, k) for k in range(2, 6)] + [(1, k) for k in range(6, 10)]
        return (*_undirected(pairs), 10, dict(loops=3, remove_edges=False, tau=30))
    if name == "flag8":
        snd, rcv, N = grid_edges(8, 8)
        return snd, rcv, N, dict(loops=12, remove_edges=True, tau=150)
    # a 6-clique (curvature 1.2 > 0.5: removal triggers) with a 6-node path
    pairs = [(a, b) for a in range(6) for b in range(a + 1, 6)] + [(k, k + 1) for k in range(5, 11)]
    return (*_undirected(pairs), 12, dict(loops=8, remove_edges=True, tau=10))


@pytest.mark.parametrize("name", ["star_bridge", "flag8", "clique_path"])
def test_sdrf_matches_jax(name):
    snd, rcv, N, kw = _sdrf_graph(name)
    want = jax_sdrf(snd, rcv, N, **kw)
    got = sdrf(snd, rcv, N, **kw)
    assert got == want
    added, removed = got
    assert len(added["senders"]) >= 2
    if kw["remove_edges"]:
        assert len(removed["senders"]) >= 2  # removal triggered
    else:
        assert removed is None


def test_reset_due_matches_jax():
    from hyper_graph_nets_tpu.models.base import reset_due as jax_reset_due

    for step, num, freq in [(0, 5, 1), (3, 10, 2), (5, 10, 2), (7, 9, 4), (1, 1, 1)]:
        assert reset_due(step, num, freq) == jax_reset_due(step, num, freq)


# -- the balancer's statics and expansion ----------------------------------------


def _balancer_config(dtype=None, agg_vjp="gather", algorithm="ricci", loops=32, **model):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    config["params"]["model"].update(
        graph_balancer={
            "algorithm": algorithm, "frequency": 1, "remove_edges": True,
            "ricci": {"loops": loops, "tau": 150}, "random": {"edge_amount": 12},
        },
        **model,
    )
    return config


@pytest.mark.parametrize("algorithm", ["ricci", "random"])
def test_prepare_static_matches_jax(algorithm):
    traj = _trajectory()
    config = _balancer_config(algorithm=algorithm, loops=6)
    jmodel, model = jax_get_model(config), get_model(config)
    jtopo = jmodel.build_topology(traj["cells"][0])
    topo = model.topology_from_trajectory(traj)
    frame0 = {k: v[0] for k, v in traj.items()}
    jstatic = jax_get_balancer(config).prepare(jmodel, frame0, jtopo)
    static = get_balancer(config).prepare(model, frame0, topo)
    assert isinstance(static, BalancerStatic)
    for name, want in jstatic._asdict().items():
        got = getattr(static, name).numpy()
        assert got.dtype == np.asarray(want).dtype and got.shape == np.asarray(want).shape, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert (static.mesh_keep == 0).any() and (static.bal_mask == 0).any()


def test_expansion_caches_until_reset():
    traj = _trajectory()
    config = _balancer_config(algorithm="random")
    model = get_model(config)
    exp = build_expansion(model, config)
    assert exp.fingerprint == jax_build_expansion(jax_get_model(config), config).fingerprint
    topo = model.topology_from_trajectory(traj)
    frame0 = {k: v[0] for k, v in traj.items()}
    s1 = exp.prepare(model, frame0, topo)
    assert exp.prepare(model, frame0, topo)[0] is s1[0] and exp.static[0] is s1[0]
    exp.reset(0, 10)
    assert exp.prepare(model, frame0, topo)[0] is not s1[0]


class _Fixed:
    """A balancing algorithm that returns a given balancing."""

    def __init__(self, added, removed):
        self.added, self.removed = added, removed

    def run(self, topo):
        return self.added, self.removed


def _hand_balancing(seed=0, n_add=20, every=7):
    """On the 10x10 flag: ``n_add`` random new undirected edges, and every
    ``every``-th mesh edge from the fourth on removed, spread through the
    mesh (each removal leaves both directions masked inside their
    receivers' segments)."""
    snd, rcv, N = grid_edges(10, 10)
    rng = np.random.default_rng(seed)
    und = [(int(s), int(r)) for s, r in zip(snd, rcv) if s > r]
    rem = und[3::every]
    taken = set(zip(snd.tolist(), rcv.tolist()))
    pairs = []
    while len(pairs) < n_add:
        a, b = (int(v) for v in rng.integers(0, N, 2))
        if a != b and (a, b) not in taken:
            taken.update({(a, b), (b, a)})
            pairs.append((a, b))
    added = dict(zip(("senders", "receivers"), (list(v) for v in _undirected(pairs))))
    removed = dict(zip(("senders", "receivers"), (list(v) for v in _undirected(rem))))
    return added, removed


def _fix(balancer_owner, balancing):
    balancer_owner.expansion.members[0]._algorithm = _Fixed(*balancing)


@functools.lru_cache(maxsize=None)
def _jax_state(dtype, agg_vjp):
    """A JAX init whose normalizers have seen the trajectory, and its numpy
    form."""
    config = _balancer_config(dtype, agg_vjp)
    model = jax_get_model(config)
    traj = _trajectory()
    state = model.init_state(jax.random.PRNGKey(0))
    topo = model.build_topology(traj["cells"][0])
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}

    @jax.jit
    def accumulate(state, frames):
        _, _, state = model.make_graph(state, topo, frames, True)
        return model.get_target(state, frames, True)[1]

    state = accumulate(state, frames)
    return state, _numpy_state(state)


@pytest.mark.parametrize("is_training", [False, True])
def test_expand_matches_jax(is_training):
    """The expanded graph (balance features, masks, neighbour matrices) and
    the mesh-edge normalizer's new state."""
    traj = _trajectory()
    config = _balancer_config()
    balancing = _hand_balancing()
    jstate, nstate = _jax_state(None, "gather")
    jmodel, model = jax_get_model(config), get_model(config)
    jexp, exp = jax_build_expansion(jmodel, config), build_expansion(model, config)
    jexp.members[0]._algorithm = exp.members[0]._algorithm = _Fixed(*balancing)
    jtopo = jmodel.build_topology(traj["cells"][0])
    topo = model.topology_from_trajectory(traj)
    frame0 = {k: v[0] for k, v in traj.items()}
    jstatic, static = jexp.prepare(jmodel, frame0, jtopo), exp.prepare(model, frame0, topo)
    jframes = {k: jnp.asarray(v[:2]) for k, v in traj.items() if k != "cells"}
    frames = {k: torch.tensor(np.asarray(v)) for k, v in jframes.items()}
    jgraph, _, js = jmodel.make_graph(jstate, jtopo, jframes, is_training)
    jgraph, js = jexp.expand(js, jgraph, jframes, jmodel, is_training, static=jstatic)
    state = state_from_jax_numpy(*nstate)
    graph, _, s = model.make_graph(state, topo, frames, is_training)
    graph, s = exp.expand(s, graph, frames, model, is_training, static=static)
    jb, b = jgraph.edge_sets["balance"], graph.edge_sets["balance"]
    np.testing.assert_allclose(b.features.numpy(), np.asarray(jb.features), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(b.mask.expand(b.features.shape[:-1]).numpy(), np.asarray(jb.mask))
    for f in ("senders", "receivers", "gather_idx", "gather_valid"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    jm, m = jgraph.edge_sets["mesh_edges"], graph.edge_sets["mesh_edges"]
    assert m.mask.shape == m.senders.shape  # the port keeps the mesh mask [E]
    np.testing.assert_array_equal(m.mask.expand(m.features.shape[:-1]).numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(m.gather_valid.numpy(), np.asarray(jm.gather_valid))
    assert (m.mask == 0).sum() == len(balancing[1]["senders"])
    _assert_normalizers_close(s.normalizers, js.normalizers)
    acc = s.normalizers["mesh_edge"].acc_count - state.normalizers["mesh_edge"].acc_count
    assert float(acc) == (2 * (len(m.senders) + len(balancing[0]["senders"])) if is_training else 0)


# -- interior masks on the sorted kernel's plain versions ------------------------


def _interior_mask_case(seed=0, L=8):
    snd, rcv, N = grid_edges(10, 10)
    mask = np.ones(len(rcv), np.float32)
    mask[3::7] = 0.0  # inside segments, spread through the mesh
    mask[rcv == 17] = 0.0  # a receiver that loses all its edges
    data = np.random.default_rng(seed).normal(size=(2, len(rcv), L)).astype(np.float32)
    return data, rcv, mask, N


def test_sorted_pna_with_interior_masks_matches_jax_gather_path():
    """The port's K4f/K4b plain versions with a mask inside segments against
    the JAX gather path's ``pna_gather`` (the same neighbour matrix, masked):
    equal forward (float32, summation order: rtol = atol = 1e-6), equal
    backward, and nothing reaches or leaves a masked edge."""
    from hyper_graph_nets_tpu.core.mesh import receivers_to_gather as jax_receivers_to_gather

    data, rcv, mask, N = _interior_mask_case()
    gidx, gval = jax_receivers_to_gather(rcv, N, mask=mask)
    g = np.random.default_rng(1).normal(size=(2, N, 4 * data.shape[-1])).astype(np.float32)

    def jloss(d):
        out = jax_segment_ops.pna_gather(d, jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(rcv), jnp.asarray(mask)[None])
        return jnp.vdot(out, g), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(data))
    x = torch.tensor(data).requires_grad_()
    plan = sorted_plan(rcv, N)  # built without the mask, as build_topology does
    out = pna_sorted(x, torch.tensor(rcv), torch.tensor(mask), N, plan=plan)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    assert bool((out[:, 17] == 0).all())
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    assert bool((x.grad[:, mask == 0] == 0).all())


def test_jax_sorted_kernel_misaggregates_interior_masks():
    """A finding about the reference: JAX's ``pna_sorted`` moves a masked
    edge's receiver past the node space, which breaks the order its CSR
    search needs when the masked edge sits inside a segment; its output then
    differs from ``segment_ops.aggregate`` with the same mask, while the
    port's sorted pna equals it."""
    data, rcv, mask, N = _interior_mask_case()
    seg_max = int(np.bincount(rcv, minlength=N).max())
    data = data[0]
    bad = np.asarray(jax_pna_sorted(jnp.asarray(data), jnp.asarray(rcv), jnp.asarray(mask), N, seg_max, True))
    want = np.asarray(jax_segment_ops.aggregate(jnp.asarray(data), jnp.asarray(rcv), N, "pna", jnp.asarray(mask)))
    assert np.abs(bad - want).max() > 0.1
    got = pna_sorted(torch.tensor(data), torch.tensor(rcv), torch.tensor(mask), N).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sorted_plan_takes_interior_masks():
    data, rcv, mask, N = _interior_mask_case()
    plan = sorted_plan(rcv, N, mask)
    rp = plan.row_ptr.numpy()
    assert plan.span == 1 + np.flatnonzero(mask)[-1] and rp[0] == 0 and rp[-1] == plan.span
    assert (np.diff(rp) >= 0).all()
    for n in range(N):  # each range holds every valid edge of its receiver, and no other
        seg = np.arange(rp[n], rp[n + 1])
        valid = seg[mask[seg] > 0]
        assert (rcv[valid] == n).all() and len(valid) == int(((rcv == n) & (mask > 0)).sum())
    # masked tail pinned to receiver 0, masked head
    tail = sorted_plan(np.r_[rcv, 0, 0], N, np.r_[mask, 0, 0])
    assert tail.span == plan.span and tail.num_edges == len(rcv) + 2
    head = sorted_plan(np.r_[5, rcv], N, np.r_[0, mask])
    assert head.row_ptr[0] == 0 and head.row_ptr[1] == 1 + int(np.argmax(rcv >= 1))


# -- serving and training with interior removed edges -----------------------------


def _frames2():
    return {k: v[:2] for k, v in _trajectory().items()}


@functools.lru_cache(maxsize=None)
def _jax_one_step(dtype, agg_vjp, removed=True):
    jstate, _ = _jax_state(dtype, agg_vjp)
    jp = JaxPredictor(_balancer_config(dtype, agg_vjp), state=jstate)
    added, rem = _hand_balancing()
    _fix(jp, (added, rem if removed else {"senders": [], "receivers": []}))
    return jp.one_step(_frames2())


def _port_one_step(dtype, agg_vjp, jax_agg="gather"):
    _, nstate = _jax_state(dtype, jax_agg)
    p = Predictor(_balancer_config(dtype, agg_vjp), state=state_from_jax_numpy(*nstate), device="cpu")
    _fix(p, _hand_balancing())
    return p, p.one_step(_frames2())


def _acc(pos):
    f = _frames2()
    return pos - (2 * f["world_pos"] - f["prev|world_pos"])


@pytest.mark.parametrize("agg_vjp", PATHS)
def test_one_step_with_removed_edges_matches_jax_gather(agg_vjp):
    before = (fused_edge_block.launches, pna_sorted.launches, maxprod.launches)
    _, got = _port_one_step(None, agg_vjp)
    assert (fused_edge_block.launches, pna_sorted.launches, maxprod.launches) == before
    refs = ("gather", "xla") if agg_vjp == "xla" else ("gather",)
    for ref in refs:
        want = _jax_one_step(None, ref)
        assert got.shape == want.shape == (2, 100, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        scale = np.abs(_acc(want)).max()
        assert np.abs(_acc(got) - _acc(want)).max() <= 1e-5 * scale, ref


@pytest.mark.parametrize("agg_vjp", ["fused", "sorted"])
def test_one_step_with_removed_edges_bfloat16(agg_vjp):
    _, got = _port_one_step("bfloat16", agg_vjp)
    want = _jax_one_step("bfloat16", "gather")
    scale = np.abs(_acc(want)).max()
    assert np.abs(_acc(got) - _acc(want)).max() <= 0.05 * scale


def test_jax_fused_path_aggregates_removed_edges():
    """A finding about the reference: JAX's fused path gives the same
    prediction with and without the removals (its kernel takes no mask), and
    so differs from JAX ``gather``; the port's fused path changes with them
    and matches ``gather``."""
    with_removal, without = _jax_one_step(None, "fused"), _jax_one_step(None, "fused", removed=False)
    np.testing.assert_array_equal(with_removal, without)
    gather = _jax_one_step(None, "gather")
    scale = np.abs(_acc(gather)).max()
    assert np.abs(_acc(with_removal) - _acc(gather)).max() > 1e-3 * scale
    assert np.abs(_acc(_jax_one_step(None, "sorted")) - _acc(gather)).max() > 1e-3 * scale
    _, port = _port_one_step(None, "fused")
    assert np.abs(_acc(port) - _acc(gather)).max() <= 1e-5 * scale


def test_rollout_with_balancer_matches_jax_gather():
    traj = _trajectory()
    jstate, nstate = _jax_state(None, "gather")
    jp = JaxPredictor(_balancer_config(None, "gather"), state=jstate)
    _fix(jp, _hand_balancing())
    want = jp.rollout(traj, num_steps=3)
    p = Predictor(_balancer_config(None, "fused"), state=state_from_jax_numpy(*nstate), device="cpu")
    _fix(p, _hand_balancing())
    got = p.rollout(traj, num_steps=3)
    np.testing.assert_allclose(got["pred_pos"], want["pred_pos"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4, atol=1e-9)
    # a prepared static in place of preparing: the same result
    static = p.expansion.static
    p.expansion.members[0]._algorithm = None  # preparing again would fail
    again = p.rollout(traj, num_steps=3, static=static)
    np.testing.assert_array_equal(again["pred_pos"], got["pred_pos"])
    np.testing.assert_array_equal(p.one_step(_frames2(), static=static), _port_one_step(None, "fused")[1])


def _train_config(dtype, agg_vjp, loops=8):
    return _balancer_config(dtype, agg_vjp, loops=loops, noise=0.003, gamma=0.9, learning_rate=1e-4)


def _jax_loss_and_grads(config, jstate, frames, normal_key, balancing):
    """``make_train_step``'s loss_fn with the expansion, at one noise key."""
    traj = _trajectory()
    model = jax_get_model(config)
    exp = jax_build_expansion(model, config)
    exp.members[0]._algorithm = _Fixed(*balancing)
    topo = model.build_topology(traj["cells"][0])
    static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = jax_add_noise(frames, model.field, model.noise_scale, model.noise_gamma, normal_key)

    def loss_fn(params, normalizers):
        mstate = JModelState(params=params, normalizers=normalizers)
        graph, _, mstate = model.make_graph(mstate, topo, frames, True)
        graph, mstate = exp.expand(mstate, graph, frames, model, is_training=True, static=static)
        target, mstate = model.get_target(mstate, frames, is_training=True)
        out = jax_batched_forward(model, mstate.params, graph)
        mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, normalizers), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params, jstate.normalizers
    )
    return float(loss), state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params, normalizers


@functools.lru_cache(maxsize=None)
def _jax_train_reference():
    config = _train_config(None, "gather")
    jstate = jax_get_model(config).init_state(jax.random.PRNGKey(0))
    jframes = {k: jnp.asarray(v) for k, v in _trajectory().items() if k != "cells"}
    _, nkey, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    normal = np.array(jax.random.normal(nkey, jframes["world_pos"].shape, jnp.float32))
    out = _jax_loss_and_grads(config, jstate, jframes, nkey, _hand_balancing())
    return jstate, jframes, normal, out


@pytest.mark.parametrize("agg_vjp", PATHS)
def test_train_step_with_removed_edges_matches_jax_gather(agg_vjp):
    jstate, jframes, normal, (jloss, jgrads, jnorm) = _jax_train_reference()
    config = _train_config(None, agg_vjp)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    _fix(trainer, _hand_balancing())
    traj = _trajectory()
    topo = model.topology_from_trajectory(traj)
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    tstate = trainer.init_train_state(state=state_from_jax_numpy(*_numpy_state(jstate)))
    frames = trainer.frames({k: np.asarray(v) for k, v in jframes.items()})
    loss, normalizers = trainer.loss_and_grads(tstate, topo, frames, normal=torch.tensor(normal), static=static)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_normalizers_close(normalizers, jnorm)
    named = dict(jgrads.named_parameters())
    assert any(n.endswith("balance.weights.0") for n in named)
    for name, p in tstate.model.params.named_parameters():
        want = named[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name
        )
    new, step_loss = trainer.train_step(tstate, topo, frames, normal=torch.tensor(normal), static=static)
    assert float(step_loss) == float(loss) and new.step == 1
    val = trainer.validation_step(new.model, topo, frames, static=static)
    assert all(np.isfinite(float(v)) for v in val)


def test_jax_train_step_with_balancer_runs_the_port_trainer_loop():
    """The JAX train step with its expansion and the port's, 2 Adam steps on
    the same noise (``xla`` on both sides, float32): losses rtol = 1e-5."""
    config = _train_config(None, "xla")
    traj = _trajectory()
    jmodel = jax_get_model(config)
    jtrainer = JaxTrainer(jmodel, config)
    jts = jtrainer.init_train_state(jax.random.PRNGKey(0))
    jexp = jax_build_expansion(jmodel, config)
    jexp.members[0]._algorithm = _Fixed(*_hand_balancing())
    jtopo = jmodel.build_topology(traj["cells"][0])
    frame0 = {k: v[0] for k, v in traj.items()}
    jstatic = jexp.prepare(jmodel, frame0, jtopo)
    jstep = jtrainer.make_train_step(jtopo, expansion=jexp)
    jframes = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}

    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    _fix(trainer, _hand_balancing())
    topo = model.topology_from_trajectory(traj)
    static = trainer.expansion.prepare(model, frame0, topo)
    ts = trainer.init_train_state(state=state_from_jax_numpy(*_numpy_state(jts.model)))
    frames = trainer.frames({k: np.asarray(v) for k, v in jframes.items()})
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        _, nkey, _ = jax.random.split(key, 3)
        normal = torch.tensor(np.array(jax.random.normal(nkey, jframes["world_pos"].shape, jnp.float32)))
        jts, jloss = jstep(jts, jframes, key, jstatic)
        ts, loss = trainer.train_step(ts, topo, frames, normal=normal, static=static)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


# -- convert ---------------------------------------------------------------------


def test_convert_carries_the_balance_edge_models():
    config = _balancer_config(None, "fused")
    jstate, nstate = _jax_state(None, "fused")
    state = state_from_jax_numpy(*nstate)
    params, _ = nstate
    net = state.params
    assert set(net.edge_encoders) == {"mesh_edges", "balance"}
    np.testing.assert_array_equal(
        net.edge_encoders["balance"].weights[0].detach().numpy(), params["encoder"]["edge_models"]["balance"]["layers"][0]["w"].T
    )
    for i, block in enumerate(net.blocks):
        assert set(block.edge_models) == {"mesh_edges", "balance"}
        for k, layer in enumerate(params["processor"]["edge_models"]["balance"]["layers"]):
            np.testing.assert_array_equal(block.edge_models["balance"].weights[k].detach().numpy(), layer["w"][i].T)
            np.testing.assert_array_equal(block.edge_models["balance"].biases[k].detach().numpy(), layer["b"][i])
        assert block.node_model.weights[0].shape[1] == 32 * (1 + 4 * 2)
    fresh = get_model(config).init_state()
    assert {n: p.shape for n, p in fresh.params.named_parameters()} == {
        n: p.shape for n, p in net.named_parameters()
    }
