"""Int8 (W8A8) serving in the port against the JAX package.

``quantize_weight``, ``dense_int8`` and ``quantize_network`` of
``hyper_graph_nets_tpu_torch/nn/quant.py`` against
``hyper_graph_nets_tpu/nn/quant.py``; ``Predictor(quantize="int8")``
one_step and a 4-step rollout on every model family and ``agg_vjp`` path
against the JAX ``Predictor`` with ``quantize="int8"`` on the same state;
the rollout and n-step evaluators under ``inference_quant: int8``; the
training state and checkpoint staying float; a JAX checkpoint served int8.

Inputs are made with numpy from seeds and go through both packages: the
10x10 flag (the 8x8 with remote message passing), the 7x5 cylinder, the 5x6
plate; latent 32 (flag) or 16 (the cut ``configs/*.yaml``), 2 blocks. The JAX
side runs its kernels as its own tests do (interpret mode); int8 sets never
reach the fused kernels in either package.

Tolerances:

- ``quantize_weight`` and ``dense_int8``: bit for bit.  The port's
  ``dense_int8`` follows the JAX forward as XLA compiles it (the activation
  scale's division by 127 folded into a multiply by float32(1/127)); the
  ``/ 127`` variant, which a test holds as the control, misses it.
- the quantized tree: the same MLPs, codes and scales, exactly.
- one_step and rollout states as served (positions; cylinder's velocity and
  pressure): at least 95% of the elements within rtol 1e-5, atol 1e-6 (the
  float parity tests' limit), and every element within 1% of the largest
  move (one_step: from the state a zero network output gives, ``2 x -
  prev`` on flag; rollout: from the first frame); rollout MSE rtol 1%.
  Every dense product is exact in int32 on both sides, but the float32
  sums around them (aggregates, LayerNorm) run in another order, and an
  activation one rounding from a code boundary then lands on the other
  code, which the next layers carry to the neighbours.  Read: every
  element within the float limit on flag, RMP and cylinder (largest error
  2.4e-3 of the move, multiscale), 0.990 of them on plate with 7.25e-3 of
  the move, 0.998 and 2.5e-3 on HGN plate.  The plate reading is one
  flipped code: moving the input positions by two float32 ulps moves the
  port's own one_step by the same 7.25e-3.  The control: the float path
  against JAX's int8 reads 0.49-0.61 of the elements within the float limit
  and 1.25-1.28% of the move on plate and HGN plate.  On flag these limits
  cannot tell int8 from float: the trajectory's target accelerations (std
  4e-6 to 3e-5) move positions of about 1 by a few hundred float32 ulps a
  step, below which the network's part vanishes.
- whole models with the network's part raised and the activation codes
  unrounded.  On flag the output normalizer's standard deviation is raised
  to 1e-2 (``_raised``).  As served, no whole-model limit then separates
  int8 from float: a one-ulp move of the input moves JAX's own int8
  one_step by 2.0-6.8% of the move, as far as int8 is from float
  (2.4-7.6%), and the port is 1.8-2.0% off JAX on Ricci and multiscale
  (2.4e-5 of the move at most where the two packages' float32 sums agree).
  So both packages' int8 dense layers are run with the activation codes
  left unrounded (``_unrounded``; the weight codes and scales, every
  layer's wiring, the dtypes and each path's aggregation as served), and
  held to: every element within ``MOVE_TOL`` (1e-3) of the largest move, at
  least ``CLOSE_SHARE`` (99%) within the float limit, the rollout MSE within
  ``MSE_RTOL`` (1e-4).  Read: 7.3e-5 of the move at most (bf16), every
  element within the float limit, MSE 1.4e-6.  The control, the port's
  float one_step against JAX's unrounded int8, reads 1.6e-3 to 4.9e-2 of
  the move and 0.5-82% of the elements within the float limit on every
  case.
- bf16: held to the same limits.  Under int8 the first product's float32
  output plus a bf16 bias is float32 in both packages, so every latent
  after the encoders is float32; each int8 layer's output cast to bf16
  instead reads 2.2e-2 of the move unrounded (checked on a copy of the
  port).
- evaluator scalars as served rtol 1% (read 1.3e-4); unrounded on the
  raised state within ``MSE_RTOL`` (read 5.2e-7) and rollout positions as
  above (2.8e-5 of the move), where the float evaluators read 5.4-5.8% on
  every scalar and 4.3% of the move.  The training state and the
  checkpoint after an int8 evaluation: bit for bit.
"""
import contextlib
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.nn import quant as jax_quant
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.simulator import MeshSimulator as JaxMeshSimulator
from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy, train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import cylinder_trajectory, plate_trajectory
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.nn import blocks, quant
from hyper_graph_nets_tpu_torch.nn.mlp import MLP
from hyper_graph_nets_tpu_torch.ops import fused_block, segment_pna
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training import checkpoint
from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
from torch_port_cases import flag_config
from torch_port_models import cut_config, numpy_state

ROLLOUT_STEPS = 4
POS_TOL = dict(rtol=1e-5, atol=1e-6)
MOVE_TOL = 1e-3
CLOSE_SHARE = 0.99
MSE_RTOL = 1e-4
FLIP_TOL = 0.01
# flag's output normalizer's standard deviation (see the module docstring)
FLAG_OUTPUT_STD = 1e-2


# -- quantize_weight and dense_int8 --------------------------------------------------


def test_quantize_weight_matches_jax_per_channel_with_a_zero_channel():
    rng = np.random.default_rng(0)
    w = (0.3 * rng.normal(size=(24, 10))).astype(np.float32)  # JAX layout [in, out]
    w[:, 4] = 0.0
    jw, js = jax_quant.quantize_weight(jnp.asarray(w))
    pw, ps = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert pw.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps[4] == 1.0 and not pw[4].any()


def test_quantize_weight_matches_jax_per_block():
    """JAX quantizes the stacked ``[blocks, in, out]`` processor weights at
    once; the port holds a block's ``[out, in]`` weight each."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 16, 8)).astype(np.float32)
    jw, js = jax_quant.quantize_weight(jnp.asarray(w))
    for b in range(3):
        pw, ps = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w[b].T)))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw[b]).T)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js[b]))


DENSE_KS = (4, 8, 12, 128, 384)
DENSE_NS = (3, 16, 128)
DENSE_CASES = [(d, k) for d in ("float32", "bfloat16") for k in DENSE_KS]


@functools.lru_cache(maxsize=None)
def _dense_cases(dtype, seed=0):
    """For each K in ``DENSE_KS``: 33 rows of spread magnitude (one all
    zero) and, for each width in ``DENSE_NS``, a weight quantized by JAX and
    JAX's jitted ``dense_int8`` (one compile for them all)."""
    rng = np.random.default_rng(seed)
    xs, jws = [], []
    for K in DENSE_KS:
        x = (rng.normal(size=(33, K)) * rng.uniform(0.05, 4.0, size=(33, 1))).astype(np.float32)
        x[5] = 0.0
        xs.append(x)
        jws.append([jax_quant.quantize_weight(jnp.asarray((0.3 * rng.normal(size=(K, n))).astype(np.float32)))
                    for n in DENSE_NS])
    wants = jax.jit(
        lambda xs, jws: [[jax_quant.dense_int8(x, *w).astype(jnp.float32) for w in ws] for x, ws in zip(xs, jws)]
    )([jnp.asarray(x).astype(dtype) for x in xs], jws)
    return {
        K: (torch.from_numpy(x).to(getattr(torch, dtype)), [
            (torch.from_numpy(np.array(jw).T.copy()), torch.from_numpy(np.array(js)), np.asarray(want))
            for (jw, js), want in zip(ws, ks_wants)
        ])
        for K, x, ws, ks_wants in zip(DENSE_KS, xs, jws, wants)
    }


def _dense_case(dtype, K):
    return _dense_cases(dtype)[K]


@pytest.mark.parametrize("dtype, K", DENSE_CASES, ids=[f"{d}-K{k}" for d, k in DENSE_CASES])
def test_dense_int8_matches_jax_bit_for_bit(dtype, K):
    """At each output width in ``DENSE_NS``."""
    x, cases = _dense_case(dtype, K)
    for (w_q, ws, want), N in zip(cases, DENSE_NS):
        got = quant.dense_int8(x, w_q, ws)
        assert got.dtype == x.dtype and got.shape == (33, N)
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"N={N}")
        # leading dims are rows too
        assert torch.equal(quant.dense_int8(x.reshape(3, 11, K), w_q, ws).reshape(33, N), got)


def _dense_int8_true_division(x, w_q, wscale):
    """The control: the activation scale as a true division by 127."""
    x32 = x.float()
    ax = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    ax = torch.where(ax > 0, ax, torch.ones_like(ax))
    x_q = torch.round(x32 / ax).clamp(-127, 127).to(torch.int8)
    return ((torch._int_mm(x_q, w_q.t()).float() * ax) * wscale).to(x.dtype)


def test_true_division_variant_fails_the_bit_for_bit_check():
    """The ``/ 127`` scale differs from JAX's folded multiply by an ulp in
    some rows, which moves codes: the check above must catch it."""
    missed = total = 0
    for dtype, K in DENSE_CASES:
        x, cases = _dense_case(dtype, K)
        for w_q, ws, want in cases:
            total += 1
            missed += not np.array_equal(_dense_int8_true_division(x, w_q, ws).float().numpy(), want)
    assert missed >= total // 4, (missed, total)


# -- whole-model cases ----------------------------------------------------------------


def _flag_traj(nx=10, steps=6):
    return jax_add_targets(jax_flag_trajectory(num_steps=steps, nx=nx, ny=nx), "world_pos", True)


def _flag(dtype=None, agg_vjp="fused", **model):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    config["params"]["model"].update(model)
    return config


def _rmp(arch, agg_vjp="fused"):
    rmp = {"clustering": "spectral", "connector": arch, "num_clusters": 4, "hyper_noise": 0.003,
           "hyper_node_features": True, "frequency": 1}
    return _flag(agg_vjp=agg_vjp, rmp=rmp)


def _ricci():
    return _flag(graph_balancer={"algorithm": "ricci", "frequency": 1, "remove_edges": True,
                                 "ricci": {"loops": 16, "tau": 150}})


def _hgn(fused_tiers):
    config = cut_config("plateCluster", "fused")
    config["params"]["model"]["rmp"].update(num_clusters=4, fused_tiers=fused_tiers)
    return config


@functools.lru_cache(maxsize=None)
def _traj(family):
    if family == "flag":
        return _flag_traj()
    if family == "rmp":
        return _flag_traj(nx=8)
    if family == "cylinder":
        return add_targets(cylinder_trajectory(num_steps=10, nx=7, ny=5, seed=1), "velocity", False)
    return add_targets(plate_trajectory(num_steps=20, nx=5, ny=6, seed=0), "world_pos", False)


# (config, trajectory family, frames served by one_step, the JAX state's key:
# configs that share parameter shapes share one state)
MODEL_CASES = {
    "flag-fused": (lambda: _flag(), "flag", slice(0, 2), "flag"),
    "flag-sorted": (lambda: _flag(agg_vjp="sorted"), "flag", slice(0, 2), "flag"),
    "flag-gather": (lambda: _flag(agg_vjp="gather"), "flag", slice(0, 2), "flag"),
    "flag-xla": (lambda: _flag(agg_vjp="xla"), "flag", slice(0, 2), "flag"),
    "flag-bf16-fused": (lambda: _flag("bfloat16"), "flag", slice(0, 2), "flag"),
    "flag-ricci": (_ricci, "flag", slice(0, 2), "flag-ricci"),
    "rmp-hyper": (lambda: _rmp("hyper"), "rmp", slice(0, 2), "rmp-hyper"),
    "rmp-multiscale": (lambda: _rmp("multiscale", "gather"), "rmp", slice(0, 2), "rmp-multiscale"),
    "cylinder": (lambda: cut_config("cylinder"), "cylinder", slice(1, 7), "cylinder"),
    "plate": (lambda: cut_config("plate"), "plate", slice(12, 18), "plate"),
    "hgn-plate": (lambda: _hgn(False), "plate", slice(12, 18), "hgn"),
    "hgn-plate-fused-tiers": (lambda: _hgn(True), "plate", slice(12, 18), "hgn"),
}


def _accumulated(config, traj):
    """A JAX init whose normalizers (an expansion's too) have seen the
    trajectory in training mode."""
    model = jax_get_model(config)
    exp = jax_build_expansion(model, config)
    topo = model.topology_from_trajectory(traj)
    static = None if exp is None else exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)

    def accumulate(state, frames):
        graph, _, state = model.make_graph(state, topo, frames, True)
        if exp is not None:
            _, state = exp.expand(state, graph, frames, model, True, key=jax.random.PRNGKey(3), static=static)
        return model.get_target(state, frames, True)[1]

    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    return jax.jit(accumulate)(model.init_state(jax.random.PRNGKey(0)), frames)


def _raised(state):
    """``state`` with its output normalizer's standard deviation raised to
    ``FLAG_OUTPUT_STD``, its mean kept."""
    ns = state.normalizers["output"]
    count = jnp.maximum(ns.acc_count, 1.0)
    mean = ns.acc_sum / count
    ns = ns.replace(acc_sum_squared=count * (mean * mean + FLAG_OUTPUT_STD ** 2))
    return state.replace(normalizers={**state.normalizers, "output": ns})


@functools.lru_cache(maxsize=None)
def _jax_state(key, raised=False):
    """The JAX state of a ``MODEL_CASES`` state key, from its first case;
    ``raised``, on flag through ``_raised``."""
    make, family, _, _ = next(c for c in MODEL_CASES.values() if c[3] == key)
    if raised:
        return _raised(_jax_state(key)) if make()["params"]["model"].get("history") else _jax_state(key)
    return _accumulated(make(), _traj(family))


def _jax_one_step(jp, batch):
    """The JAX ``Predictor``'s one_step; for cylinder, whose update is a
    (velocity, pressure) pair that its ``one_step`` cannot stack, the same
    computation returning the pair."""
    if jp.model.field != "velocity":
        return jp.one_step(batch)
    model, topo = jp.model, jp._topology(batch)

    def fn(state, frames):
        graph, _, _ = model.make_graph(state, topo, frames, False)
        out = jax_batched_forward(model, state.params, graph)
        return jax.vmap(lambda f, o: model.update(state, f, o), in_axes=({k: 0 for k in frames}, 0))(frames, out)

    frames = {k: jnp.asarray(v) for k, v in batch.items() if k != "cells"}
    return tuple(np.asarray(v) for v in jax.jit(fn)(jp.state, frames))


def _assert_int8_close(got, want, start):
    """``got`` against ``want``, both states moved on from ``start``: at
    least 95% of the elements within ``POS_TOL`` and every one within
    ``FLIP_TOL`` of the largest move (see the module docstring)."""
    move = float(np.abs(want - start).max())
    err = np.abs(got - want)
    assert err.max() <= FLIP_TOL * move, (float(err.max()), move)
    close = err <= POS_TOL["atol"] + POS_TOL["rtol"] * np.abs(want)
    assert close.mean() >= 0.95, float(close.mean())


def _no_network_update(batch, field):
    """The next state with a zero network output: ``2 x - prev`` with
    history (flag), else the current state."""
    prev = batch.get(f"prev|{field}")
    return batch[field] if prev is None else 2 * batch[field] - prev


@functools.lru_cache(maxsize=None)
def _jax_outputs(case):
    """The JAX int8 ``Predictor``'s one_step and rollout that a case is held
    to: its own config's, but for ``hgn-plate-fused-tiers`` those of
    ``hgn-plate`` (tiers off): the JAX package's int8 sets never fuse, so
    its tier plans go unused."""
    if case == "hgn-plate-fused-tiers":
        return _jax_outputs("hgn-plate")
    make, family, frames, key = MODEL_CASES[case]
    traj = _traj(family)
    jp = JaxPredictor(make(), state=_jax_state(key), quantize="int8")
    return _jax_one_step(jp, {k: v[frames] for k, v in traj.items()}), jp.rollout(traj, num_steps=ROLLOUT_STEPS)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_predictor_int8_matches_jax(case, monkeypatch):
    """one_step and a 4-step rollout of ``Predictor(quantize="int8")``
    against the JAX ``Predictor(quantize="int8")`` of the same config and
    state, as served; int8 products counted and no kernel on the way (none
    launches on the CPU; int8 sets never take the fused path, so K1's plain
    version is not called either)."""
    make, family, frames, key = MODEL_CASES[case]
    config, traj = make(), _traj(family)
    jstate = _jax_state(key)
    p = Predictor(config, state=state_from_jax_numpy(*numpy_state(jstate)), device="cpu", quantize="int8")
    assert p.state.params.decoder.quantized and p.state.params.node_encoder.weights[0].dtype == torch.int8
    batch = {k: v[frames] for k, v in traj.items()}
    field = "velocity" if family == "cylinder" else "world_pos"
    launches, calls = (fused_block.fused_edge_block.launches, segment_pna.pna_sorted.launches), quant.int8_matmul.calls
    monkeypatch.setattr(blocks, "_fused_update_and_agg", lambda *a: pytest.fail("an int8 set took the fused path"))
    want_one_step, want_rollout = _jax_outputs(case)
    got, want = p.one_step(batch), want_one_step
    if family == "cylinder":
        _assert_int8_close(got[1], want[1], batch["pressure"])
        got, want = got[0], want[0]
    _assert_int8_close(got, want, _no_network_update(batch, field))
    got, want = p.rollout(traj, num_steps=ROLLOUT_STEPS), want_rollout
    pred = "pred_velocity" if family == "cylinder" else "pred_pos"
    _assert_int8_close(got[pred], want[pred], traj[field][:1])
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=FLIP_TOL)
    assert (fused_block.fused_edge_block.launches, segment_pna.pna_sorted.launches) == launches
    assert quant.int8_matmul.calls > calls


@pytest.mark.parametrize("case", ["plate", "hgn-plate"])
def test_the_float_path_fails_the_int8_limits(case):
    """The control of the served limits: the port's float one_step of the
    same state against JAX's int8 one (read: 0.486 and 0.611 of the
    elements within the float limit, 1.28% and 1.25% of the move)."""
    make, family, frames, key = MODEL_CASES[case]
    p = Predictor(make(), state=state_from_jax_numpy(*numpy_state(_jax_state(key))), device="cpu")
    batch = {k: v[frames] for k, v in _traj(family).items()}
    with pytest.raises(AssertionError):
        _assert_int8_close(p.one_step(batch), _jax_outputs(case)[0], batch["world_pos"])


# -- whole models with the activation codes unrounded --------------------------------


def _jax_dense_unrounded(x, w_q, wscale):
    """JAX's ``dense_int8`` with the activation codes left unrounded:
    ``x / ax`` against the int8 weight codes in float32, the same epilogue."""
    x32 = x.astype(jnp.float32)
    ax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0
    ax = jnp.where(ax > 0, ax, 1.0)
    y = jnp.matmul(x32 / ax, w_q.astype(jnp.float32), precision="highest")
    return (y * ax * wscale).astype(x.dtype)


def _port_dense_unrounded(x, w_q, wscale):
    """The port's counterpart of ``_jax_dense_unrounded`` (``w_q`` is
    ``[out, in]``)."""
    x32 = x.float()
    ax = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    ax = torch.where(ax > 0, ax, torch.ones_like(ax))
    return (((x32 / ax) @ w_q.float().t()) * ax * wscale).to(x.dtype)


@contextlib.contextmanager
def _unrounded():
    """Every int8 dense layer of both packages unrounded, for what is traced
    and run inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_quant, "dense_int8", _jax_dense_unrounded)
        mp.setattr(quant, "dense_int8", _port_dense_unrounded)
        yield


def _outputs(one_step, rollout, family):
    """The arrays a case compares: the one_step update(s) and (with a
    rollout) the rollout's predicted field; and the rollout's MSE."""
    one = list(one_step) if isinstance(one_step, tuple) else [one_step]
    if rollout is None:
        return one, None
    return one + [rollout["pred_velocity" if family == "cylinder" else "pred_pos"]], rollout["mse"]


@functools.lru_cache(maxsize=None)
def _jax_unrounded_outputs(case):
    """The unrounded JAX int8 ``Predictor``'s one_step and rollout
    (``_outputs``) on the raised state (``_raised``); for
    ``hgn-plate-fused-tiers`` those of ``hgn-plate``, as above."""
    if case == "hgn-plate-fused-tiers":
        return _jax_unrounded_outputs("hgn-plate")
    make, family, frames, key = MODEL_CASES[case]
    traj = _traj(family)
    with _unrounded():
        jp = JaxPredictor(make(), state=_jax_state(key, raised=True), quantize="int8")
        return _outputs(_jax_one_step(jp, {k: v[frames] for k, v in traj.items()}),
                        jp.rollout(traj, num_steps=ROLLOUT_STEPS), family)


def _port_outputs(case, quantize="int8", rollout=True):
    """The port's ``Predictor`` outputs (``_outputs``) of a case on the
    raised state and the states they moved from: one_step from the state a
    zero network output gives (``2 x - prev`` on flag; cylinder's pressure
    from the current one), the rollout from the first frame."""
    make, family, frames, key = MODEL_CASES[case]
    traj, field = _traj(family), _field(family)
    p = Predictor(make(), state=state_from_jax_numpy(*numpy_state(_jax_state(key, raised=True))), device="cpu",
                  quantize=quantize)
    batch = {k: v[frames] for k, v in traj.items()}
    out = _outputs(p.one_step(batch), p.rollout(traj, num_steps=ROLLOUT_STEPS) if rollout else None, family)
    starts = [_no_network_update(batch, field)] + ([batch["pressure"]] if family == "cylinder" else [])
    return out, starts + [traj[field][:1]]


def _field(family):
    return "velocity" if family == "cylinder" else "world_pos"


def _assert_unrounded_close(got, want, starts):
    """Unrounded int8 arrays against JAX's: every element within
    ``MOVE_TOL`` of the largest move from its start, at least
    ``CLOSE_SHARE`` of them within ``POS_TOL``."""
    for g, w, s in zip(got, want, starts, strict=True):
        err = np.abs(g - w)
        move = float(np.abs(w - s).max())
        assert err.max() <= MOVE_TOL * move, (float(err.max()), move)
        close = err <= POS_TOL["atol"] + POS_TOL["rtol"] * np.abs(w)
        assert close.mean() >= CLOSE_SHARE, float(close.mean())


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_predictor_int8_matches_jax_unrounded(case, monkeypatch):
    """one_step and a 4-step rollout of ``Predictor(quantize="int8")``
    against JAX's on the raised state with the activation codes unrounded
    in both packages: every weight code and scale, every layer's wiring and
    dtype, each path's aggregation, held to ``_assert_unrounded_close`` and
    the MSE to ``MSE_RTOL``."""
    monkeypatch.setattr(blocks, "_fused_update_and_agg", lambda *a: pytest.fail("an int8 set took the fused path"))
    with _unrounded():
        (got, mse), starts = _port_outputs(case)
    want, want_mse = _jax_unrounded_outputs(case)
    _assert_unrounded_close(got, want, starts)
    np.testing.assert_allclose(mse, want_mse, rtol=MSE_RTOL)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_the_float_path_fails_the_unrounded_limits(case):
    """The control: the port's float one_step of the raised state against
    JAX's unrounded int8 one (the module docstring's readings)."""
    (got, _), starts = _port_outputs(case, quantize=None, rollout=False)
    want, _ = _jax_unrounded_outputs(case)
    with pytest.raises(AssertionError):
        # the one_step arrays only: the rollout's is the last
        _assert_unrounded_close(got, want[:-1], starts[:-1])


def test_quantized_tree_has_jax_codes():
    """``quantize_network`` of HGN plate (the world-edge encoder's 4 inputs,
    the decoder's 3 outputs, the hyper encoder, the tier sets' edge models,
    the hierarchical node models) against JAX's ``quantize_network`` of the
    same parameters: the same MLPs and layers, codes and scales exactly,
    biases and LayerNorm float32 and equal; the float network untouched."""
    config = _hgn(False)
    jstate = _jax_state("hgn")
    jq = jax_quant.quantize_network(jstate.params)
    state = state_from_jax_numpy(*numpy_state(jstate))
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    qnet = quant.quantize_network(state.params)
    # the JAX codes and scales as port networks: a layer's "w" is its codes,
    # or its scales as a one-input weight
    def as_float(tree, key):
        if isinstance(tree, dict):
            if "w_q" in tree:
                w = np.asarray(tree[key], np.float32)
                return {"w": w if key == "w_q" else w[..., None, :], "b": np.asarray(tree["b"])}
            return {k: as_float(v, key) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [as_float(v, key) for v in tree]
        return np.asarray(tree)

    codes = dict(state_from_jax_numpy(as_float(jax.tree.map(np.asarray, jq), "w_q"), {}).params.named_parameters())
    scales = dict(state_from_jax_numpy(as_float(jax.tree.map(np.asarray, jq), "wscale"), {}).params.named_parameters())
    got = dict(qnet.named_parameters())
    mlps = [m for m in qnet.modules() if isinstance(m, MLP)]
    assert all(m.quantized for m in mlps) and len(mlps) == sum(1 for m in state.params.modules() if isinstance(m, MLP))
    weights = sorted(n for n in got if ".weights." in n)
    assert weights == sorted(n for n in codes if ".weights." in n)
    assert any(tuple(got[n].shape) == (16, 4) for n in weights)  # the world-edge encoder's first layer
    assert tuple(qnet.decoder.weights[-1].shape) == (3, 16)
    for n in weights:
        assert got[n].dtype == torch.int8
        np.testing.assert_array_equal(got[n].numpy(), codes[n].detach().numpy().astype(np.int8), err_msg=n)
        s = n.replace(".weights.", ".wscales.")
        np.testing.assert_array_equal(got[s].numpy(), scales[n].detach().numpy()[:, 0], err_msg=s)
    for n, p in state.params.named_parameters():
        assert torch.equal(p, before[n]), n
        if ".weights." not in n:
            assert got[n].dtype == torch.float32 and torch.equal(got[n], p), n


def test_quantizing_an_int8_network_copies_it():
    """An int8 state passed to ``Predictor(quantize="int8")`` again keeps
    its codes and scales (quantizing the codes would set every scale to 1)."""
    net = quant.quantize_network(get_model(_flag()).init_state().params)
    again = quant.quantize_network(net)
    pairs = list(zip(net.named_parameters(), again.named_parameters()))
    assert pairs and all(n == m and torch.equal(a, b) and a is not b for (n, a), (m, b) in pairs)


def test_inference_state_without_int8_is_the_state():
    model = get_model(_flag())
    state = model.init_state()
    assert model.inference_state(state) is state


def test_predictor_leaves_the_callers_config_as_it_was():
    config = _flag()
    kept = copy.deepcopy(config)
    p = Predictor(config, device="cpu", quantize="int8")
    assert config == kept and "inference_quant" not in config["params"]["model"]
    assert p.params["model"]["inference_quant"] == "int8" and p.state.params.decoder.quantized


# -- the evaluators, the training state and checkpoints -----------------------------


def _task_config():
    config = _flag(inference_quant="int8", noise=0.003, gamma=0.9, learning_rate=1e-4)
    config["params"]["task"] = {
        "task": "mesh", "dataset": "flag_minimal", "batch_size": 4, "epochs": 1, "n_timesteps": 10,
        "trajectories": 1, "test": {"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": 3},
        "validation": {"trajectories": 1, "rollouts": 1, "n_viz": 1},
    }
    config["params"]["random_seed"] = 0
    return config


EVALUATOR_SCALARS = ("rollout_loss", "rollout_loss_last", "n_step_loss", "n_step_last_loss")


def _jax_train_numpy(jts):
    adam = jts.opt_state[0]
    params, normalizers = numpy_state(jts.model)
    tree = lambda t: jax.tree.map(np.asarray, t)
    return params, normalizers, tree(adam.mu), tree(adam.nu), adam.count, jts.step


def test_evaluators_int8_match_jax_and_leave_the_state_float(tmp_path, monkeypatch):
    """The rollout and n-step evaluators under ``inference_quant: int8`` on
    the JAX simulator's initial state (normalizers accumulated over the
    validation trajectory): as served, scalars and rollout positions against
    JAX's, with int8 products counted; on the raised state (``_raised``)
    with the activation codes unrounded in both packages, scalars within
    ``MSE_RTOL`` and rollout positions within ``_assert_unrounded_close``
    of JAX's, which the port's float evaluators must fail (the control).
    Afterwards the training states are float and bit for bit what they
    were, and a checkpoint saved after them is float and loads bit for
    bit."""
    config = _task_config()
    data = lambda: jax_get_data(config, "valid", data_dir=str(tmp_path / "data"))
    jsim = JaxMeshSimulator(config, out_dir=str(tmp_path / "jax"))
    jts = jsim.initialize()
    traj = next(iter(data()))
    jts = jts.replace(model=_accumulated(config, {k: np.asarray(v) for k, v in traj.items()}))
    jts_raised = jts.replace(model=_raised(jts.model))
    sim = MeshSimulator(config, out_dir=str(tmp_path / "port"), device="cpu")
    sim.initialize()
    ts = train_state_from_jax_numpy(sim.trainer, *_jax_train_numpy(jts))
    ts_raised = train_state_from_jax_numpy(sim.trainer, *_jax_train_numpy(jts_raised))
    before = {n: p.detach().clone() for n, p in ts.model.params.named_parameters()}

    calls = quant.int8_matmul.calls
    got = sim.rollout_evaluator(ts, data(), n_rollouts=1, num_steps=10, save=False)
    want = jsim.rollout_evaluator(jts, data(), n_rollouts=1, num_steps=10, save=False)
    for k in ("rollout_loss", "rollout_loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=FLIP_TOL, err_msg=k)
    _assert_int8_close(got["rollouts"][0]["pred_pos"], np.asarray(want["rollouts"][0]["pred_pos"]),
                       np.asarray(traj["world_pos"][:1]))
    got = sim.n_step_evaluator(ts, data(), n_step=3, n_trajectories=1, num_timesteps=10)
    want = jsim.n_step_evaluator(jts, data(), n_step=3, n_trajectories=1, num_timesteps=10)
    for k in ("n_step_loss", "n_step_last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=FLIP_TOL, err_msg=k)
    assert quant.int8_matmul.calls > calls

    def evaluate(s, state):
        out = s.rollout_evaluator(state, data(), n_rollouts=1, num_steps=10, save=False)
        out.update(s.n_step_evaluator(state, data(), n_step=3, n_trajectories=1, num_timesteps=10))
        return out

    with _unrounded():
        # a JAX simulator of its own: the one above keeps its compiled programs
        junrounded = JaxMeshSimulator(config, out_dir=str(tmp_path / "jax_unrounded"))
        got, want = evaluate(sim, ts_raised), evaluate(junrounded, jts_raised)

    def check(out):
        for k in EVALUATOR_SCALARS:
            np.testing.assert_allclose(out[k], want[k], rtol=MSE_RTOL, err_msg=k)
        _assert_unrounded_close([out["rollouts"][0]["pred_pos"]], [np.asarray(want["rollouts"][0]["pred_pos"])],
                                [np.asarray(traj["world_pos"][:1])])

    check(got)
    with monkeypatch.context() as mp:
        mp.setattr(sim.model, "inference_state", lambda state: state)
        floats = evaluate(sim, ts_raised)
    with pytest.raises(AssertionError):
        check(floats)

    for state in (ts, ts_raised):
        assert not any(isinstance(m, MLP) and m.quantized for m in state.model.params.modules())
        assert all(p.dtype == torch.float32 for p in state.model.params.parameters())
    for n, p in ts.model.params.named_parameters():
        assert torch.equal(p, before[n]), n
    path = checkpoint.save(str(tmp_path / "ckpt"), config, ts, 1)
    loaded, epoch, _ = checkpoint.load(path, sim.trainer)
    assert epoch == 1
    for n, p in loaded.model.params.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n


def test_jax_checkpoint_serves_int8_in_the_port(tmp_path):
    """A JAX ``.pkl`` checkpoint through ``Predictor.from_config(...,
    quantize="int8")``: bit for bit the int8 ``Predictor`` of the converted
    state, and within the positions' limit of the JAX int8 ``Predictor``;
    the port's own ``.pt`` checkpoint of that state serves the same bits."""
    config = _flag()
    traj = _traj("flag")
    jstate = _jax_state("flag")
    jts = JaxTrainer(jax_get_model(config), config).init_train_state(jax.random.PRNGKey(0))
    path = jax_checkpoint.save(str(tmp_path / "jax"), config, jts.replace(model=jstate), 1)
    batch = {k: v[:2] for k, v in traj.items()}
    served = Predictor.from_config(config, checkpoint=path, device="cpu", quantize="int8")
    got = served.one_step(batch)
    state = state_from_jax_numpy(*numpy_state(jstate))
    assert np.array_equal(got, Predictor(config, state=state, device="cpu", quantize="int8").one_step(batch))
    want = JaxPredictor(config, state=jstate, quantize="int8").one_step(batch)
    _assert_int8_close(got, want, _no_network_update(batch, "world_pos"))
    sim = MeshSimulator(config, out_dir=str(tmp_path / "port"), device="cpu")
    pt = checkpoint.save(str(tmp_path / "port"), config, sim.trainer.init_train_state(state=state), 1)
    again = Predictor.from_config(config, checkpoint=pt, device="cpu", quantize="int8").one_step(batch)
    assert np.array_equal(again, got)
