"""K2 and K3, the fused edge block's backward: the port against the JAX package.

The port's ``fused_edge_block`` under autograd runs ``FusedEdgeBlock``; on
the CPU its backward is the plain K2 (``bwd='remat'``) or K3
(``bwd='stream'``).  The JAX side differentiates its ``fused_edge_block``
(``_bwd_kernel`` / ``_bwd_stream_kernel`` in interpret mode), as
tests/test_fused_block.py does.  Both take the gradient of
``vdot(e2 * mask, ge2) + vdot(agg, gagg)``; masked rows get a zero ``e2``
cotangent, as in test_fused_block.py:113-115.

Tolerances:
- float32: those of test_fused_block.py:128-140 (edge and node gradients
  atol = 3e-4; weight gradients atol = 3e-3, rtol = 1e-4).
- bf16: the max/min parts of ``gagg`` are zero.  In interpret mode on the
  CPU, the JAX kernel's bf16 remat does not reproduce its own forward's e2
  bit for bit (XLA keeps excess precision differently in the two kernels),
  so its exact tie compare misses and it drops g_max/g_min for most
  receivers (measured: 40 to 89 of 126 receivers routed per column, against
  126 and more for the port); the port's routing is checked against the
  exact tie count below instead.  Each gradient is within a relative L2
  error of 2**-6 and an absolute error of 2**-6 of its largest element:
  both sides round to bf16 at the same points, but a sum in another order
  rounds the other way by one unit in the last place (2**-7 relative), and
  such differences pass through the LayerNorm and MLP backward.
- K3 against K2 (both plain): the streams K3 reads are K1's own values, so
  de, dh, dz2, dz3, dsp and drp agree to rtol = 1e-6 (as
  test_fused_block.py:144-177), and the column sums to 1e-6 of their scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.ops.pallas.fused_block import (
    build_band_plan,
    fused_edge_block as jax_fused_edge_block,
)
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.nn.blocks import GNNConfig
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    EDGE_WEIGHT_KEYS,
    agg_cotangent_rhs,
    fused_edge_block,
    fused_edge_block_bwd,
    fused_edge_block_bwd_reference,
    fused_edge_block_bwd_stream,
    fused_edge_block_bwd_stream_reference,
    fused_edge_block_reference,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import (
    flag_config,
    long_segment_case,
    masked_edge_case,
    tie_edge_case,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 2.0**-6


def _case(name, seed=4):
    """Inputs, the JAX band plan and the port's mask (None: all valid)."""
    if name == "masked":
        arrays, weights, snd, rcv, mask, N, nv = masked_edge_case(seed=seed)
        return arrays, weights, snd, rcv, mask, N, build_band_plan(snd, rcv, N, num_valid=nv, chunk=128)
    if name == "ties":
        arrays, weights, snd, rcv, _, N, _ = tie_edge_case(seed=seed)
    else:
        arrays, weights, snd, rcv, _, N = long_segment_case(seed=seed)
    return arrays, weights, snd, rcv, None, N, build_band_plan(snd, rcv, N, chunk=128)


def _cotangents(arrays, N, mask, route=True, seed=9):
    B, E, L = arrays["e"].shape
    rng = np.random.default_rng(seed)
    m = np.ones(E, np.float32) if mask is None else mask
    ge2 = (rng.normal(size=(B, E, L)) * m[None, :, None]).astype(np.float32)
    gagg = rng.normal(size=(B, N, 4 * L)).astype(np.float32)
    if not route:
        gagg[..., 2 * L :] = 0.0
    return ge2, gagg


def _jax_grads(arrays, weights, plan, N, mask, ge2, gagg, dtype, bwd):
    jdt = DTYPES[dtype][0]
    m = np.ones(ge2.shape[1], np.float32) if mask is None else mask

    def loss(e, sp, rp, w):
        e2, agg = jax_fused_edge_block(e, sp, rp, w, plan, N, interpret=True, bwd=bwd)
        return jnp.vdot(e2.astype(jnp.float32) * m[None, :, None], ge2) + jnp.vdot(agg, gagg)

    args = [jnp.asarray(arrays[k]).astype(jdt) for k in ("e", "sp", "rp")]
    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*args, {k: jnp.asarray(v) for k, v in weights.items()})
    out = {k: np.asarray(v.astype(jnp.float32)) for k, v in zip(("e", "sp", "rp"), g[:3])}
    out.update({k: np.asarray(v) for k, v in g[3].items()})
    return out


def _port_tensors(arrays, weights, snd, rcv, mask, dtype):
    tdt = DTYPES[dtype][1]
    t = {k: torch.tensor(arrays[k]).to(tdt).requires_grad_() for k in ("e", "sp", "rp")}
    w = {
        k: torch.tensor(v.T.copy() if v.ndim == 2 else v).requires_grad_()
        for k, v in weights.items()
    }
    idx = (torch.tensor(snd), torch.tensor(rcv), None if mask is None else torch.tensor(mask))
    return t, w, idx


def _port_grads(arrays, weights, snd, rcv, mask, N, ge2, gagg, dtype, bwd, reference=False):
    """Gradients in the JAX layout; ``reference`` differentiates the plain
    forward by autograd instead of going through FusedEdgeBlock."""
    t, w, (ts, tr, tm) = _port_tensors(arrays, weights, snd, rcv, mask, dtype)
    if reference:
        e2, agg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, ts, tr, tm, N)
    else:
        e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, tm, N, bwd=bwd)
    assert e2.grad_fn is not None and agg.grad_fn is not None
    m = torch.ones(ge2.shape[1]) if tm is None else tm
    loss = (e2.float() * m[None, :, None] * torch.tensor(ge2)).sum() + (agg * torch.tensor(gagg)).sum()
    names = ["e", "sp", "rp"] + list(EDGE_WEIGHT_KEYS)
    leaves = [t["e"], t["sp"], t["rp"]] + [w[k] for k in EDGE_WEIGHT_KEYS]
    grads = torch.autograd.grad(loss, leaves)
    out = {}
    for n, g in zip(names, grads):
        g = g.float().numpy()
        out[n] = g.T if n in ("we", "w2", "w3") else g
    return out


def _assert_grads_close(got, want, dtype, mask=None):
    for k, j in want.items():
        p = got[k]
        if k == "e" and mask is not None:  # masked rows' own cotangent is dead
            p, j = p * mask[None, :, None], j * mask[None, :, None]
        if dtype == "float32":
            tol = dict(atol=3e-4) if k in ("e", "sp", "rp") else dict(atol=3e-3, rtol=1e-4)
            np.testing.assert_allclose(p, j, err_msg=k, **tol)
        else:
            scale = float(np.abs(j).max())
            assert np.linalg.norm(p - j) <= BF16_TOL * np.linalg.norm(j), k
            assert np.abs(p - j).max() <= BF16_TOL * scale, k


@pytest.mark.parametrize("bwd", ["remat", "stream"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["masked", "long_segments"])
def test_backward_matches_jax(case, dtype, bwd):
    """Gradients of e, sp, rp and the 8 weights: plain K2 / K3 against the
    JAX kernels, with a masked tail and an isolated receiver, or receivers
    longer than a tile."""
    arrays, weights, snd, rcv, mask, N, plan = _case(case)
    ge2, gagg = _cotangents(arrays, N, mask, route=dtype == "float32")
    want = _jax_grads(arrays, weights, plan, N, mask, ge2, gagg, dtype, bwd)
    k2, k3 = fused_edge_block_bwd.launches, fused_edge_block_bwd_stream.launches
    got = _port_grads(arrays, weights, snd, rcv, mask, N, ge2, gagg, dtype, bwd)
    # the CPU runs the plain versions and never counts a launch
    assert (fused_edge_block_bwd.launches, fused_edge_block_bwd_stream.launches) == (k2, k3)
    _assert_grads_close(got, want, dtype, mask)


def _tie_count(e2, agg, rcv, L, part):
    """Per column: the edges whose e2 equals their receiver's max (part 2)
    or min (part 3) exactly, summed over the batch."""
    ext = agg[:, torch.as_tensor(rcv).long(), part * L : (part + 1) * L]
    return (e2.float() == ext).float().sum(dim=(0, 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tied_edges_each_get_the_full_cotangent(dtype):
    """Duplicated edges tie exactly.  With only g_max = g_min = 1, the routed
    mass (the lnb gradient, the column sum of the routed cotangent) equals
    the count of edges that equal their receiver's extremum: every tied edge
    gets all of it, and every receiver routes at least once per column.
    Autograd through the plain forward splits the cotangent among tied edges
    instead (scatter_reduce), so its mass is one per receiver: that is the
    fault FusedEdgeBlock fixes."""
    arrays, weights, snd, rcv, _, N, copies = tie_edge_case(seed=1)
    B, E, L = arrays["e"].shape
    gagg = np.zeros((B, N, 4 * L), np.float32)
    gagg[..., 2 * L :] = 1.0
    t, w, (ts, tr, _) = _port_tensors(arrays, weights, snd, rcv, None, dtype)
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, None, N)
    (dlnb, de) = torch.autograd.grad((agg * torch.tensor(gagg)).sum(), [w["lnb"], t["e"]])
    want = _tie_count(e2, agg, rcv, L, 2) + _tie_count(e2, agg, rcv, L, 3)
    receivers = B * len(np.unique(rcv))
    assert torch.equal(dlnb, want)
    assert bool((want >= 2 * receivers).all()) and bool((want > 2 * receivers).any())
    # the two copies of a duplicated edge get the same cotangent
    assert torch.equal(de[:, copies], de[:, copies - 1])

    t, w, _ = _port_tensors(arrays, weights, snd, rcv, None, dtype)
    _, ragg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, ts, tr, None, N)
    (split,) = torch.autograd.grad((ragg * torch.tensor(gagg)).sum(), [w["lnb"]])
    # one per receiver and part; in bf16 a third of a three-way tie rounds
    torch.testing.assert_close(split, torch.full_like(split, 2.0 * receivers), rtol=2**-10, atol=0)
    assert float((want - split).max()) >= 1.0


def test_ties_match_jax_float32():
    """In float32 the JAX kernel routes ties exactly too: on the duplicated
    edges the port's gradients match it, and autograd through the plain
    forward (ties split) does not."""
    arrays, weights, snd, rcv, mask, N, plan = _case("ties", seed=2)
    B, E, L = arrays["e"].shape
    ge2, gagg = _cotangents(arrays, N, mask)
    gagg[..., 2 * L :] = 4.0  # the routed part dominates
    want = _jax_grads(arrays, weights, plan, N, mask, ge2, gagg, "float32", "remat")
    got = _port_grads(arrays, weights, snd, rcv, mask, N, ge2, gagg, "float32", "remat")
    _assert_grads_close(got, want, "float32")
    split = _port_grads(arrays, weights, snd, rcv, mask, N, ge2, gagg, "float32", "remat", True)
    assert np.abs(split["lnb"] - want["lnb"]).max() > 1.0


def _plain_inputs(dtype, seed=5):
    arrays, weights, snd, rcv, mask, N, _ = masked_edge_case(seed=seed, B=3)
    t, w, (ts, tr, tm) = _port_tensors(arrays, weights, snd, rcv, mask, dtype)
    t = {k: v.detach() for k, v in t.items()}
    w = {k: v.detach() for k, v in w.items()}
    e2, agg, *streams = fused_edge_block_reference(
        t["e"], t["sp"], t["rp"], w, ts, tr, tm, N, save_streams=True
    )
    ge2, gagg = _cotangents(arrays, N, mask, seed=seed)
    de2 = torch.tensor(ge2).to(t["e"].dtype)
    drhs = agg_cotangent_rhs(agg, torch.tensor(gagg), tr, tm, N)
    return t, w, (ts, tr, tm, N), streams, de2, drhs


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stream_backward_matches_remat(dtype):
    """Plain K3 (fed K1's streams) against plain K2 (recomputing)."""
    t, w, topo, streams, de2, drhs = _plain_inputs(dtype)
    k2 = fused_edge_block_bwd_reference(t["e"], t["sp"], t["rp"], w, de2, drhs, *topo)
    k3 = fused_edge_block_bwd_stream_reference(t["e"], *streams, w, de2, drhs, *topo)
    for name, a, b in zip(("de", "dh", "dz2", "dz3"), k2[:4], k3[:4]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=name)
    torch.testing.assert_close(k2[4], streams[0], rtol=0, atol=0)  # a1
    torch.testing.assert_close(k2[5], streams[1], rtol=0, atol=0)  # a2
    for a, b in zip(k2[6:8], k3[4:6]):  # dsp, drp
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    torch.testing.assert_close(k2[8], k3[6], rtol=1e-6, atol=1e-6 * float(k2[8].abs().max()))
    # the wrappers take the plain versions on the CPU
    got = fused_edge_block_bwd_stream(t["e"], *streams, w, de2, drhs, *topo)
    assert all(torch.equal(a, b) for a, b in zip(got, k3))


def test_bad_fused_bwd_raises():
    arrays, weights, snd, rcv, mask, N, _ = masked_edge_case()
    t, w, (ts, tr, tm) = _port_tensors(arrays, weights, snd, rcv, mask, "float32")
    with pytest.raises(ValueError, match="remat.*stream"):
        fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, tm, N, bwd="Stream")
    with pytest.raises(ValueError, match="remat.*stream"):
        GNNConfig(output_size=3, node_in_dim=5, edge_in_dims=(("mesh_edges", 7),), fused_bwd="x")
    config = flag_config(None)
    config["params"]["model"]["fused_bwd"] = "streams"
    with pytest.raises(ValueError, match="remat.*stream"):
        get_model(config).gnn_config


@pytest.mark.parametrize("bwd", ["remat", "stream"])
def test_fused_path_gradients_reach_every_edge_parameter(bwd):
    """Under grad the fused path keeps the autograd graph: gradients reach
    each block's edge MLP (its edge part We, W2, W3, biases and LayerNorm),
    the first layer's sender and receiver parts through the aggregates into
    the node path, and the edge encoder."""
    config = flag_config(None)
    config["params"]["model"].update(noise=0.003, gamma=0.9, fused_bwd=bwd)
    traj = add_targets(flag_trajectory(num_steps=4, nx=6, ny=6), "world_pos", True)
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    tstate = trainer.init_train_state(torch.Generator().manual_seed(3))
    topo = model.topology_from_trajectory(traj, device="cpu")
    loss, _ = trainer.loss_and_grads(
        tstate, topo, trainer.frames(traj), generator=torch.Generator().manual_seed(4)
    )
    assert torch.isfinite(loss)
    params = tstate.model.params
    L = model.latent_size
    for i, block in enumerate(params.blocks):
        em = block.edge_models["mesh_edges"]
        g1 = em.weights[0].grad
        for part, cols in (("sender", slice(0, L)), ("receiver", slice(L, 2 * L)), ("edge", slice(2 * L, None))):
            assert float(g1[:, cols].abs().sum()) > 0, (i, part)
        for p in [*em.weights[1:], *em.biases, em.ln_scale, em.ln_bias]:
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, i
    for p in params.edge_encoders["mesh_edges"].parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0
