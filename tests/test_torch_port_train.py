"""The port's Trainer against the JAX package's (``make_train_step``,
``make_validation_step``, the learning-rate schedule).

Same weights (a JAX init moved by ``convert.state_from_jax_numpy``; the
gradient tree has the parameters' layout and converts with the same
function), same frames (3 frames of a 10x10 synthetic flag), latent 32, 2
blocks, noise 0.003, gamma 0.9, lr 1e-4.  The noise is JAX's draw:
``trainer.py:159-163`` splits the step key three ways and draws
``jax.random.normal`` from the second; the test repeats that and hands the
draw to the port.  The JAX side runs the fused Pallas kernels in interpret
mode; the port runs on the CPU, where every kernel wrapper takes its plain
version.

Tolerances:
- float32: loss rtol = 1e-5; every gradient within rtol = 1e-4 and
  atol = 1e-5 of its largest element (summation order only; measured 2e-6
  relative); normalizer states rtol = 1e-5; losses of 3 Adam steps
  rtol = 1e-5 and the parameters after them atol = 1e-6 (measured 1.6e-7).
- bf16 (fused, remat): the loss within 2**-8 of JAX's fused path.  The
  gradients and parameters are held against JAX's ``agg_vjp: gather`` path,
  which routes the max/min cotangent to every tied edge as the fused path
  does, but from the saved aggregate: in interpret mode on the CPU the JAX
  fused kernel's bf16 remat misses its own ties and drops g_max/g_min for
  most receivers (tests/test_torch_port_backward.py).  Gradients compare by
  relative L2 norm per tensor within 2**-3: single elements differ by a bf16
  rounding in either direction, and the bias and LayerNorm gradients are
  sums over all edges that cancel, so elementwise tolerances say nothing
  there; the port's ``xla`` path against JAX's ``xla`` path, which agree on
  tie handling, differ by up to 5.8e-2 on the same tensors.  Adam moves a
  parameter by at most about lr per step whatever the gradient's size, so
  after 3 steps the parameters agree within 10 * lr.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.training.trainer import (
    Trainer as JaxTrainer,
    add_noise as jax_add_noise,
    batched_forward as jax_batched_forward,
    frames_to_batches as jax_frames_to_batches,
)
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block_bwd
from hyper_graph_nets_tpu_torch.training.trainer import Trainer, frames_to_batches
from torch_port_cases import flag_config

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
LR = 1e-4


def _config(dtype, agg_vjp, bwd="remat", **model):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    config["params"]["model"].update(
        noise=0.003, gamma=0.9, learning_rate=LR, fused_bwd=bwd, **model
    )
    return config


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


class _Setup:
    """A JAX trainer and a port trainer on the same state and frames."""

    def __init__(self, dtype, jax_agg, port_agg, bwd="remat"):
        traj = jax_add_targets(jax_flag_trajectory(num_steps=6, nx=10, ny=10), "world_pos", True)
        jconfig, config = _config(dtype, jax_agg, bwd), _config(dtype, port_agg, bwd)
        self.jmodel = jax_get_model(jconfig)
        self.jtrainer = JaxTrainer(self.jmodel, jconfig)
        self.jstate = self.jtrainer.init_train_state(jax.random.PRNGKey(0))
        self.jtopo = self.jmodel.build_topology(traj["cells"][0])
        self.jframes = {k: jnp.asarray(v[:3]) for k, v in traj.items() if k != "cells"}
        self.model = get_model(config)
        self.trainer = Trainer(self.model, config, device="cpu")
        self.state = self.trainer.init_train_state(
            state=state_from_jax_numpy(*_numpy_state(self.jstate.model))
        )
        self.topo = self.model.topology_from_trajectory(traj, device="cpu")
        self.frames = self.trainer.frames({k: np.array(v) for k, v in self.jframes.items()})

    def noise(self, key):
        """The standard-normal draw JAX's train step makes from ``key``."""
        _, nkey, _ = jax.random.split(key, 3)
        x = self.jframes["world_pos"]
        return nkey, jax.random.normal(nkey, x.shape, x.dtype)

    def jax_loss_and_grads(self, key):
        """``loss_fn`` of trainer.py:143-156 with the step's noise."""
        model, topo = self.jmodel, self.jtopo
        nkey, _ = self.noise(key)
        frames = jax_add_noise(self.jframes, model.field, model.noise_scale, model.noise_gamma, nkey)

        def loss_fn(params, normalizers):
            mstate = JModelState(params=params, normalizers=normalizers)
            graph, _, mstate = model.make_graph(mstate, topo, frames, True)
            target, mstate = model.get_target(mstate, frames, is_training=True)
            out = jax_batched_forward(model, mstate.params, graph)
            mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
            loss = jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1])
            return loss, mstate.normalizers

        (loss, normalizers), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            self.jstate.model.params, self.jstate.model.normalizers
        )
        return float(loss), state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params, normalizers

    def port_loss_and_grads(self, key):
        _, normal = self.noise(key)
        loss, normalizers = self.trainer.loss_and_grads(
            self.state, self.topo, self.frames, normal=torch.tensor(np.array(normal))
        )
        return float(loss), normalizers

    def steps(self, n):
        """n train steps on both sides; returns their losses."""
        step = self.jtrainer.make_train_step(self.jtopo)
        losses = []
        for i in range(n):
            key = jax.random.PRNGKey(10 + i)
            _, normal = self.noise(key)
            self.jstate, jloss = step(self.jstate, self.jframes, key)
            self.state, loss = self.trainer.train_step(
                self.state, self.topo, self.frames, normal=torch.tensor(np.array(normal))
            )
            losses.append((float(jloss), float(loss)))
        return losses


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            np.testing.assert_allclose(
                getattr(got[name], f).numpy(), np.asarray(getattr(ns, f)),
                rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(getattr(ns, f))).max()),
                err_msg=f"{name}.{f}",
            )


@pytest.mark.parametrize(
    "agg_vjp,bwd", [("fused", "remat"), ("fused", "stream"), ("xla", "remat")],
    ids=["fused_remat", "fused_stream", "xla"],
)
def test_train_step_matches_jax_float32(agg_vjp, bwd):
    s = _Setup(None, agg_vjp, agg_vjp, bwd)
    k2 = fused_edge_block_bwd.launches
    jloss, jgrads, jnorm = s.jax_loss_and_grads(jax.random.PRNGKey(1))
    loss, normalizers = s.port_loss_and_grads(jax.random.PRNGKey(1))
    assert fused_edge_block_bwd.launches == k2  # the CPU never launches
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_normalizers_close(normalizers, jnorm)
    named = dict(jgrads.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        want = named[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name
        )

    old = {k: v.acc_sum.clone() for k, v in s.state.model.normalizers.items()}
    first = s.state.model.normalizers
    for jl, pl in s.steps(3):
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert s.state.step == 3
    # train_step returns new normalizer states and leaves the old ones be
    assert all(torch.equal(first[k].acc_sum, old[k]) for k in old)
    want = state_from_jax_numpy(*_numpy_state(s.jstate.model))
    _assert_normalizers_close(s.state.model.normalizers, want.normalizers)
    wparams = dict(want.params.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), wparams[name].detach().numpy(), rtol=0, atol=1e-6, err_msg=name
        )


def test_train_step_matches_jax_bfloat16():
    fused = _Setup("bfloat16", "fused", "fused")
    jloss, _, _ = fused.jax_loss_and_grads(jax.random.PRNGKey(1))
    loss, _ = fused.port_loss_and_grads(jax.random.PRNGKey(1))
    assert abs(loss - jloss) <= 2**-8 * abs(jloss)

    s = _Setup("bfloat16", "gather", "fused")
    _, jgrads, jnorm = s.jax_loss_and_grads(jax.random.PRNGKey(1))
    _, normalizers = s.port_loss_and_grads(jax.random.PRNGKey(1))
    _assert_normalizers_close(normalizers, jnorm)
    named = dict(jgrads.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        want = named[name].detach().numpy()
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 2**-3 * np.linalg.norm(want), (name, err / np.linalg.norm(want))
    for jl, pl in s.steps(3):
        assert abs(pl - jl) <= 2**-8 * abs(jl)
    wparams = dict(state_from_jax_numpy(*_numpy_state(s.jstate.model)).params.named_parameters())
    for name, p in s.state.model.params.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), wparams[name].detach().numpy(), rtol=0, atol=10 * LR, err_msg=name
        )


def test_learning_rate_schedule_matches_optax():
    config = _config(None, "fused", lr_decay_steps=50, lr_decay_rate=0.1, lr_min=3e-6)
    trainer = Trainer(get_model(config), config, device="cpu")
    schedule = optax.exponential_decay(
        init_value=LR, transition_steps=50, decay_rate=0.1, end_value=3e-6
    )
    for count in (0, 1, 7, 49, 50, 51, 120, 400):
        np.testing.assert_allclose(trainer.learning_rate(count), float(schedule(count)), rtol=1e-6)
    constant = Trainer(get_model(_config(None, "fused")), _config(None, "fused"), device="cpu")
    assert constant.learning_rate(0) == constant.learning_rate(1000) == LR


def test_learning_rate_reaches_the_optimizer():
    """With decay, each step's Adam update runs at that step's rate."""
    config = _config(None, "fused", lr_decay_steps=1, lr_decay_rate=0.5, lr_min=1e-9)
    s = _Setup(None, "fused", "fused")
    trainer = Trainer(s.model, config, device="cpu")
    state = trainer.init_train_state(state=s.state.model)
    for i in range(2):
        state, _ = trainer.train_step(state, s.topo, s.frames, generator=torch.Generator().manual_seed(i))
        assert state.opt_state.param_groups[0]["lr"] == LR * 0.5**i


def test_validation_step_matches_jax():
    s = _Setup(None, "fused", "fused")
    want = s.jtrainer.make_validation_step(s.jtopo)(s.jstate.model, s.jframes)
    got = s.trainer.validation_step(s.state.model, s.topo, s.frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_noise_from_a_generator_is_reproducible():
    s = _Setup(None, "fused", "fused")
    losses = []
    for _ in range(2):
        state = s.trainer.init_train_state(state=s.state.model)
        _, loss = s.trainer.train_step(state, s.topo, s.frames, generator=torch.Generator().manual_seed(7))
        losses.append(float(loss))
    assert losses[0] == losses[1]


def test_frames_to_batches_matches_jax():
    traj = jax_add_targets(jax_flag_trajectory(num_steps=9, nx=5, ny=5), "world_pos", True)
    want = list(jax_frames_to_batches(traj, 3))
    got = list(frames_to_batches(traj, 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_rmp_trainer_raises():
    """RMP runs in the port with every clustering the JAX package has
    (spectral, random, k-means, the mixture, HDBSCAN); a name neither
    package knows is refused when the Trainer is built."""
    config = _config("bfloat16", "fused")
    config["params"]["model"]["rmp"] = {"clustering": "optics", "connector": "hyper"}
    with pytest.raises(NotImplementedError, match="unknown clustering algorithm 'optics'"):
        Trainer(get_model(config), config, device="cpu")
