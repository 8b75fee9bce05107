"""``agg_vjp: sorted`` and ``agg_vjp: gather``: the port against the JAX package.

The sorted path's pna runs K4f forward and K4b backward
(``ops/segment_pna.py``); on the CPU each wrapper takes its plain version.
The JAX side runs its ``pna_sorted`` Pallas kernels in interpret mode, as
tests/test_segment_pna.py does.  The gather path (``core/segment_ops.py``:
``gather_aggregate``, ``pna_gather``, ``gather_rows``) is plain code in both
packages.  Inputs are drawn with numpy from a seed; weights are a JAX init
moved by ``convert.state_from_jax_numpy``; training noise is JAX's draw, as
in test_torch_port_train.py.

Tolerances:
- float32 aggregates: rtol = atol = 1e-5 (the JAX kernel sums by segmented
  scans, the port in edge order); max and min exactly equal.
- bf16 aggregates: sum and mean within one bf16 unit in the last place of
  the value (2**-7 relative) plus 1e-5 absolute: both sum in float32 and
  round once, and float32 sums in another order may round to the
  neighbouring bf16 value; max and min exactly equal.
- K4b and the gather path's backward: float32 rtol = atol = 1e-6 (the same
  float32 steps; only XLA's fusion may round the mean term differently);
  bf16 within one bf16 unit of the value.  Tied edges each get the full
  max/min cotangent, checked exactly.
- Block activations, serving and training: as test_torch_port_model.py and
  test_torch_port_train.py state them for float32; bf16 train-step
  gradients within a relative L2 norm of 2**-4 per tensor (single elements
  round the other way, see test_torch_port_train.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.core import segment_ops as jax_segment_ops
from hyper_graph_nets_tpu.core.graph import EdgeSet as JEdgeSet, Graph as JGraph
from hyper_graph_nets_tpu.core.mesh import receivers_to_gather as jax_receivers_to_gather
from hyper_graph_nets_tpu.nn.blocks import GNNConfig as JGNNConfig
from hyper_graph_nets_tpu.nn.meshgraphnet import (
    network_apply as jax_network_apply,
    network_init as jax_network_init,
)
from hyper_graph_nets_tpu.ops.pallas.segment_pna import pna_sorted as jax_pna_sorted
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph
from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
from hyper_graph_nets_tpu_torch.nn.blocks import GNNConfig
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import network_apply
from hyper_graph_nets_tpu_torch.ops.segment_pna import (
    pna_sorted,
    pna_sorted_bwd,
    pna_sorted_bwd_reference,
    pna_sorted_reference,
    sorted_plan,
)
from hyper_graph_nets_tpu_torch.serving import Predictor
from test_torch_port_model import _numpy_state, _trained_normalizer_state, _trajectory
from test_torch_port_train import _assert_normalizers_close, _Setup
from torch_port_cases import BF16_ULP, flag_config, grid_edges

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sorted_case(seed, N, E_valid, E, L, B=None, empty=(), ties=True):
    """Receiver-sorted valid edges, a masked tail pinned to receiver 0 (the
    JAX package's padding convention), receivers in ``empty`` without edges,
    and, with ``ties``, every third edge a copy of the one before it when
    both share a receiver (exact ties in every column)."""
    rng = np.random.default_rng(seed)
    ids = np.setdiff1d(np.arange(N), np.asarray(empty, int))
    rcv_v = np.sort(rng.choice(ids, size=E_valid)).astype(np.int32)
    rcv = np.concatenate([rcv_v, np.zeros(E - E_valid, np.int32)])
    mask = np.r_[np.ones(E_valid), np.zeros(E - E_valid)].astype(np.float32)
    data = rng.normal(size=(E, L) if B is None else (B, E, L)).astype(np.float32)
    copies = [i for i in range(3, E_valid, 3) if rcv[i] == rcv[i - 1]]
    if ties:
        for i in copies:
            data[..., i, :] = data[..., i - 1, :]
    seg_max = max(int(np.bincount(rcv_v, minlength=N).max()), 1)
    return data, rcv, mask, seg_max, np.asarray(copies)


CASES = {
    # N not a multiple of 128, empty receivers, a masked tail, ties
    "masked": dict(seed=0, N=200, E_valid=650, E=704, L=8, empty=(5, 77, 199)),
    "batched": dict(seed=1, N=150, E_valid=520, E=576, L=16, B=3, empty=(0, 149)),
    "partial_block": dict(seed=2, N=37, E_valid=120, E=128, L=8),
}


def _inputs(case, dtype):
    data, rcv, mask, seg_max, copies = _sorted_case(**CASES[case])
    jdt, tdt = DTYPES[dtype]
    jd = jnp.asarray(data).astype(jdt)
    td = torch.tensor(data).to(tdt)
    return jd, td, rcv, mask, seg_max, copies, CASES[case]["N"]


def _jax_pna(jd, rcv, mask, N, seg_max):
    return jax_pna_sorted(jd, jnp.asarray(rcv), jnp.asarray(mask), N, seg_max, True)


def _assert_pna_close(got, want, dtype):
    """Sum and mean within the dtype's tolerance, max and min exactly."""
    L = got.shape[-1] // 4
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    rtol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(g[..., : 2 * L], w[..., : 2 * L], rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(g[..., 2 * L :], w[..., 2 * L :])


# -- K4f and K4b: plain versions against JAX's pna_sorted ----------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pna_sorted_forward_matches_jax(case, dtype):
    jd, td, rcv, mask, seg_max, _, N = _inputs(case, dtype)
    want = _jax_pna(jd, rcv, mask, N, seg_max)
    plan = sorted_plan(rcv, N, mask)
    got = pna_sorted(td, torch.tensor(rcv), torch.tensor(mask), N, plan=plan)
    assert got.dtype == td.dtype and got.shape == tuple(want.shape)
    _assert_pna_close(got, want, dtype)
    empty = list(CASES[case].get("empty", ()))
    assert bool((got[..., empty, :] == 0).all())
    plain = pna_sorted_reference(td, torch.tensor(rcv), torch.tensor(mask), N)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pna_sorted_backward_matches_jax(case, dtype):
    """Autograd through ``pna_sorted`` (plain K4b on the CPU) against
    ``jax.vjp`` of JAX's kernel, on a random cotangent."""
    jd, td, rcv, mask, seg_max, _, N = _inputs(case, dtype)
    out, vjp = jax.vjp(lambda d: _jax_pna(d, rcv, mask, N, seg_max), jd)
    g = np.random.default_rng(7).normal(size=out.shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    x = td.clone().requires_grad_()
    y = pna_sorted(x, torch.tensor(rcv), torch.tensor(mask), N)
    y.backward(torch.tensor(g).to(tdt))
    assert x.grad.dtype == tdt
    w = np.asarray(want.astype(jnp.float32))
    rtol, atol = (1e-6, 1e-6) if dtype == "float32" else (BF16_ULP, 1e-6)
    np.testing.assert_allclose(x.grad.float().numpy(), w, rtol=rtol, atol=atol)
    assert bool((x.grad[..., CASES[case]["E_valid"] :, :] == 0).all())  # masked tail


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pna_sorted_tied_edges_each_get_the_full_cotangent(dtype):
    """Only g_max = g_min = 1: each edge's cotangent counts how many of its
    receiver's extrema it equals, and both copies of a tied edge get the
    same, as in JAX's kernel, where a split cotangent would give 1/2."""
    jd, td, rcv, mask, seg_max, copies, N = _inputs("masked", dtype)
    L = td.shape[-1]
    out, vjp = jax.vjp(lambda d: _jax_pna(d, rcv, mask, N, seg_max), jd)
    g = np.zeros(out.shape, np.float32)
    g[..., 2 * L :] = 1.0
    (want,) = vjp(jnp.asarray(g).astype(DTYPES[dtype][0]))
    tout = pna_sorted(td, torch.tensor(rcv), torch.tensor(mask), N)
    got = pna_sorted_bwd(torch.tensor(g).to(td.dtype), tout, td, torch.tensor(rcv), torch.tensor(mask), N)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    c = torch.as_tensor(copies)
    assert torch.equal(got[c], got[c - 1])
    r = torch.tensor(rcv).long()[: CASES["masked"]["E_valid"]]
    d = td.float()[: len(r)]
    tied = sum((d == tout.float()[r, k * L : (k + 1) * L]).float() for k in (2, 3))
    assert torch.equal(got.float()[: len(r)], tied)
    assert bool((tied[c] >= 1).any())  # some copies are their receiver's extremum


def test_pna_sorted_bwd_reference_steps():
    """The plain K4b's float32 steps: ``g_sum + g_mean * (1/deg)`` per node,
    then the routed extrema, then the mask, then one rounding."""
    data, rcv, mask, _, _ = _sorted_case(3, 20, 60, 64, 4, ties=False)
    mask[10] = 0.5  # a fractional weight inside a range
    td = torch.tensor(data)
    out = pna_sorted_reference(td, torch.tensor(rcv), torch.tensor(mask), 20)
    g = torch.tensor(np.random.default_rng(4).normal(size=(20, 16)).astype(np.float32))
    got = pna_sorted_bwd_reference(g, out, td, torch.tensor(rcv), torch.tensor(mask), 20)
    e, n = 10, int(rcv[10])
    deg = float((rcv[:60] == n).sum())
    want = g[n, :4] + g[n, 4:8] * (1.0 / deg)
    want = want + torch.where(td[e] == out[n, 8:12], g[n, 8:12], 0.0)
    want = (want + torch.where(td[e] == out[n, 12:], g[n, 12:], 0.0)) * 0.5
    assert torch.equal(got[e], want)
    assert bool((got[60:] == 0).all())


def test_sorted_plan_contract():
    """A masked tail lies past the span; a masked edge inside the valid
    ones (a mesh edge the balancer removed) stays in its receiver's range,
    which the kernels skip; the valid receivers must be non-decreasing."""
    data, rcv, mask, _, _ = _sorted_case(5, 30, 90, 100, 4)
    plan = sorted_plan(rcv, 30, mask)
    assert plan.span == 90 and plan.num_edges == 100 and plan.num_nodes == 30
    np.testing.assert_array_equal(
        plan.row_ptr.numpy(), np.searchsorted(rcv[:90], np.arange(31), side="left")
    )
    assert sorted_plan(rcv[:90], 30).span == 90
    interior = sorted_plan(rcv, 30, np.r_[mask[:50], 0.0, mask[51:]])
    # only a receiver whose first edge is the masked one starts one edge later
    assert interior.span == 90 and set((interior.row_ptr - plan.row_ptr).tolist()) <= {0, 1}
    with pytest.raises(ValueError, match="non-decreasing"):
        sorted_plan(rcv[::-1].copy(), 30)
    with pytest.raises(ValueError, match="lie in"):
        sorted_plan(rcv[:90], 10)


# -- the gather path's pieces against the JAX package --------------------------


@pytest.mark.parametrize("kind", ["receivers", "senders", "masked", "min_degree"])
def test_receivers_to_gather_matches_jax(kind):
    snd, rcv, N = grid_edges(7, 9)
    ids = snd if kind == "senders" else rcv
    kw = {}
    if kind == "masked":
        kw["mask"] = (np.arange(len(ids)) % 5 != 0).astype(np.float32)
    if kind == "min_degree":
        kw["min_degree"] = 11
    ours, theirs = receivers_to_gather(ids, N, **kw), jax_receivers_to_gather(ids, N, **kw)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _tied_gather_case(seed=8, B=2, L=6):
    """A 6x6 grid whose every third receiver gets its first edge twice (an
    exact tie), a masked edge, and the neighbour matrices."""
    rng = np.random.default_rng(seed)
    snd, rcv, N = grid_edges(6, 6)
    dup = [int(np.flatnonzero(rcv == n)[0]) for n in range(0, N, 3)]
    order = np.sort(np.concatenate([np.arange(len(rcv)), dup]))  # copies adjacent
    data = rng.normal(size=(B, len(rcv), L)).astype(np.float32)[:, order]
    snd, rcv = snd[order], rcv[order]
    mask = np.ones(len(rcv), np.float32)
    mask[7] = 0.0
    copies = np.flatnonzero(np.diff(order) == 0) + 1
    return data, snd, rcv, mask, N, copies


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pna_gather_gradient_matches_jax_on_ties(dtype):
    data, snd, rcv, mask, N, copies = _tied_gather_case()
    gidx, gval = receivers_to_gather(rcv, N, mask=mask)
    jdt, tdt = DTYPES[dtype]
    g = np.random.default_rng(9).normal(size=(2, N, 4 * data.shape[-1])).astype(np.float32)

    def jloss(d):
        out = jax_segment_ops.pna_gather(
            d, jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(rcv), jnp.asarray(mask)[None]
        )
        return jnp.vdot(out.astype(jnp.float32), g), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(data).astype(jdt))
    x = torch.tensor(data).to(tdt).requires_grad_()
    out = segment_ops.pna_gather(x, torch.tensor(gidx), torch.tensor(gval), torch.tensor(rcv), torch.tensor(mask))
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    (out * torch.tensor(g)).sum().backward()
    want = np.asarray(jgrad.astype(jnp.float32))
    rtol = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=rtol, atol=1e-6)
    # both copies of a tied edge get the full cotangent; the masked edge none
    assert torch.equal(x.grad[:, copies], x.grad[:, copies - 1])
    assert bool((x.grad[:, 7] == 0).all())


def test_gather_rows_gradient_matches_jax():
    data, snd, rcv, mask, N, _ = _tied_gather_case()
    sidx, sval = receivers_to_gather(snd, N)
    x = np.random.default_rng(10).normal(size=(2, N, 5)).astype(np.float32)
    g = np.random.default_rng(11).normal(size=(2, len(snd), 5)).astype(np.float32)
    jgrad = jax.grad(
        lambda v: jnp.vdot(jax_segment_ops.gather_rows(v, jnp.asarray(snd), jnp.asarray(sidx), jnp.asarray(sval)), g)
    )(jnp.asarray(x))
    t = torch.tensor(x).requires_grad_()
    rows = segment_ops.gather_rows(t, torch.tensor(snd), torch.tensor(sidx), torch.tensor(sval))
    assert torch.equal(rows, t[:, torch.tensor(snd).long()])
    (rows * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("aggregation", ["sum", "mean", "max", "min", "pna"])
def test_gather_aggregate_matches_jax(aggregation):
    data, snd, rcv, mask, N, _ = _tied_gather_case()
    gidx, gval = receivers_to_gather(rcv, N, mask=mask)
    want = jax_segment_ops.gather_aggregate(jnp.asarray(data), jnp.asarray(gidx), jnp.asarray(gval), aggregation)
    got = segment_ops.gather_aggregate(torch.tensor(data), torch.tensor(gidx), torch.tensor(gval), aggregation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- block gradients: the tie rule of gather and sorted through the network ----


def _net_case():
    """A 6x6 grid whose every third receiver gets its first edge twice, with
    identical features: the copies' latents tie in every block."""
    rng = np.random.default_rng(12)
    snd, rcv, N = grid_edges(6, 6)
    dup = [int(np.flatnonzero(rcv == n)[0]) for n in range(0, N, 3)]
    order = np.sort(np.concatenate([np.arange(len(rcv)), dup]))
    nodes = rng.normal(size=(N, 5)).astype(np.float32)
    edges = rng.normal(size=(len(rcv), 7)).astype(np.float32)[order]
    return nodes, edges, snd[order], rcv[order], N


def _cfg_kwargs(agg_vjp):
    return dict(
        output_size=3, node_in_dim=5, edge_in_dims=(("mesh_edges", 7),), latent_size=16,
        num_layers=2, message_passing_steps=2, aggregation="pna", agg_vjp=agg_vjp,
    )


@pytest.mark.parametrize("agg_vjp", ["gather", "sorted"])
def test_block_gradients_with_ties_match_jax(agg_vjp):
    """Gradients of the network's output through two blocks under
    ``agg_vjp: gather`` or ``sorted`` with exactly tied edges: every tied
    edge takes the full max/min cotangent, as in the JAX package.  (Before
    the gather path's repair the port split it, and the first gradient
    checked here, the node encoder's LayerNorm scale, differed by up to
    20%.)  float32: rtol = 1e-4 and atol = 1e-5 of
    each gradient's largest element (summation order)."""
    nodes, edges, snd, rcv, N = _net_case()
    gidx, gval = receivers_to_gather(rcv, N)
    sidx, sval = receivers_to_gather(snd, N)
    g = np.random.default_rng(13).normal(size=(N, 3)).astype(np.float32)
    jcfg = JGNNConfig(**_cfg_kwargs(agg_vjp))
    jparams = jax_network_init(jax.random.PRNGKey(0), jcfg)
    jes = dict(
        senders=jnp.asarray(snd), receivers=jnp.asarray(rcv), gather_idx=jnp.asarray(gidx),
        gather_valid=jnp.asarray(gval), snd_gather_idx=jnp.asarray(sidx), snd_gather_valid=jnp.asarray(sval),
    )

    def jloss(p):
        graph = JGraph(
            node_features=jnp.asarray(nodes),
            edge_sets={"mesh_edges": JEdgeSet(features=jnp.asarray(edges), **jes)},
        )
        return jnp.vdot(jax_network_apply(p, graph, jcfg), g)

    jgrads = jax.grad(jloss)(jparams)
    state = state_from_jax_numpy(jax.tree.map(np.asarray, jparams), {})
    want = dict(state_from_jax_numpy(jax.tree.map(np.asarray, jgrads), {}).params.named_parameters())
    cfg = GNNConfig(**_cfg_kwargs(agg_vjp))
    t = lambda a: torch.tensor(a)
    graph = Graph(
        node_features=t(nodes),
        edge_sets={
            "mesh_edges": EdgeSet(
                features=t(edges), senders=t(snd), receivers=t(rcv),
                plan=sorted_plan(rcv, N) if agg_vjp == "sorted" else None,
                gather_idx=t(gidx), gather_valid=t(gval), snd_gather_idx=t(sidx), snd_gather_valid=t(sval),
            )
        },
    )
    (network_apply(state.params, graph, cfg) * t(g)).sum().backward()
    for name, p in state.params.named_parameters():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()), err_msg=name
        )


# -- serving and training with agg_vjp: sorted ----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_sorted_matches_jax(dtype):
    config = flag_config(None if dtype == "float32" else dtype, agg_vjp="sorted")
    traj = _trajectory()
    jstate = _trained_normalizer_state(config, traj)
    frames2 = {k: v[:2] for k, v in traj.items()}
    jp = JaxPredictor(config, state=jstate)
    port = Predictor(config, state=state_from_jax_numpy(*_numpy_state(jstate)), device="cpu")
    before = (pna_sorted.launches, pna_sorted_bwd.launches)
    got, want = port.one_step(frames2), jp.one_step(frames2)
    assert got.shape == want.shape == (2, 100, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        r, jr = port.rollout(traj, num_steps=3), jp.rollout(traj, num_steps=3)
        np.testing.assert_allclose(r["pred_pos"], jr["pred_pos"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["mse"], jr["mse"], rtol=1e-4, atol=1e-9)
    else:
        base = 2 * frames2["world_pos"] - frames2["prev|world_pos"]
        scale = np.abs(want - base).max()
        assert np.abs(got - want).max() <= 0.05 * scale
    assert (pna_sorted.launches, pna_sorted_bwd.launches) == before  # the CPU never launches


def test_train_step_sorted_matches_jax_float32():
    """Loss, normalizers and gradients of one step, then 3 Adam steps, with
    the tolerances of test_torch_port_train.py's float32 test."""
    s = _Setup(None, "sorted", "sorted")
    jloss, jgrads, jnorm = s.jax_loss_and_grads(jax.random.PRNGKey(1))
    loss, normalizers = s.port_loss_and_grads(jax.random.PRNGKey(1))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_normalizers_close(normalizers, jnorm)
    named = dict(jgrads.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        want = named[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name
        )
    for jl, pl in s.steps(3):
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = dict(state_from_jax_numpy(*_numpy_state(s.jstate.model)).params.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("agg_vjp", ["sorted", "gather"])
def test_train_step_matches_jax_bfloat16_same_path(agg_vjp):
    """bf16 loss within 2**-8 and gradients within relative L2 2**-4 of the
    JAX package on the same path: unlike the fused kernel, the JAX sorted and
    gather backwards route ties exactly in interpret mode."""
    s = _Setup("bfloat16", agg_vjp, agg_vjp)
    jloss, jgrads, _ = s.jax_loss_and_grads(jax.random.PRNGKey(1))
    loss, _ = s.port_loss_and_grads(jax.random.PRNGKey(1))
    assert abs(loss - jloss) <= 2**-8 * abs(jloss)
    named = dict(jgrads.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        want = named[name].detach().numpy()
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 2**-4 * np.linalg.norm(want), (name, err / np.linalg.norm(want))
