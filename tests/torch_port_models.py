"""A system model of the JAX package and its port on one state, for the
cylinder and plate parity tests (tests/test_torch_port_cylinder.py,
test_torch_port_plate.py).

The configs are the shipped ``configs/<name>.yaml`` cut to a few blocks and
a narrow latent; the JAX side draws its init and accumulates every
normalizer over the trajectory in training mode (so the features are
standardized as in a trained model), and ``convert.state_from_jax_numpy``
moves that state to the port.  The noise of a train step is JAX's draw
(``trainer.py:159-163``), handed to the port.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import torch

from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.training.trainer import (
    add_noise as jax_add_noise,
    batched_forward as jax_batched_forward,
)
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from hyper_graph_nets_tpu_torch.utils.config import read_yaml

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def cut_config(name: str, agg_vjp: str = "fused", **model) -> dict:
    """``configs/<name>.yaml`` at latent 16 and 2 blocks, float32 unless
    ``model`` says otherwise."""
    config = copy.deepcopy(read_yaml(name))
    config["params"]["model"].update(
        latent_size=16, message_passing_steps=2, agg_vjp=agg_vjp, compute_dtype=None, **model
    )
    return config


def numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


class ModelPair:
    """The JAX model and the port's (on the CPU) on one converted state, with
    both packages' topologies of ``traj``."""

    def __init__(self, name, traj, agg_vjp="fused", jax_agg=None, **model):
        self.traj, self.name, self.model_overrides = traj, name, model
        self.jconfig = cut_config(name, jax_agg or agg_vjp, **model)
        self.config = cut_config(name, agg_vjp, **model)
        self.jmodel, self.model = jax_get_model(self.jconfig), get_model(self.config)
        self.jtopo = self.jmodel.topology_from_trajectory(traj)
        self.topo = self.model.topology_from_trajectory(traj, device="cpu")
        self.jstate = jax.jit(self._accumulated)(self.jmodel.init_state(jax.random.PRNGKey(0)), self.jframes())
        self.state = state_from_jax_numpy(*numpy_state(self.jstate))

    def _accumulated(self, jstate, frames):
        _, _, jstate = self.jmodel.make_graph(jstate, self.jtopo, frames, True)
        return self.jmodel.get_target(jstate, frames, True)[1]

    def jax_path(self, agg_vjp):
        """A JAX model of another ``agg_vjp`` path and its topology of the
        trajectory; it shares the JAX state (the parameters do not depend on
        the path)."""
        model = jax_get_model(cut_config(self.name, agg_vjp, **self.model_overrides))
        return model, model.topology_from_trajectory(self.traj)

    def jframes(self, sl=slice(None)):
        return {k: jnp.asarray(v[sl]) for k, v in self.traj.items() if k != "cells"}

    def jax_one_step(self, sl):
        """The JAX package's one-step update of frames ``sl`` (as its
        ``Predictor.one_step`` computes it)."""
        model = self.jmodel

        def fn(state, frames):
            graph, _, _ = model.make_graph(state, self.jtopo, frames, False)
            out = jax_batched_forward(model, state.params, graph)
            axes = ({k: 0 for k in frames}, 0)
            return jax.vmap(lambda f, o: model.update(state, f, o), in_axes=axes)(frames, out)

        return jax.jit(fn)(self.jstate, self.jframes(sl))

    def noise(self, key, sl):
        """The standard-normal draw JAX's train step makes from ``key``."""
        _, nkey, _ = jax.random.split(key, 3)
        x = self.jframes(sl)[self.jmodel.field]
        return nkey, jax.random.normal(nkey, x.shape, x.dtype)

    def jax_loss_and_grads(self, key, sl):
        """``loss_fn`` of trainer.py:143-156 with the step's noise: (loss,
        gradients as the port's parameters, normalizers, counters)."""
        model, topo = self.jmodel, self.jtopo
        nkey, _ = self.noise(key, sl)
        frames = jax_add_noise(self.jframes(sl), model.field, model.noise_scale, model.noise_gamma, nkey)

        def loss_fn(params, normalizers):
            mstate = JModelState(params=params, normalizers=normalizers)
            graph, aux, mstate = model.make_graph(mstate, topo, frames, True)
            target, mstate = model.get_target(mstate, frames, is_training=True)
            out = jax_batched_forward(model, mstate.params, graph)
            mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
            loss = jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1])
            return loss, mstate.normalizers

        (loss, normalizers), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            self.jstate.params, self.jstate.normalizers
        )
        return float(loss), state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params, normalizers

    def port_train_step(self, key, sl):
        """The port's train step on the same state, frames and noise:
        (trainer, train state after it, loss, counters); the gradients stay
        in the parameters' ``.grad``."""
        trainer = Trainer(self.model, self.config, device="cpu")
        ts = trainer.init_train_state(state=self.state)
        _, normal = self.noise(key, sl)
        frames = trainer.frames({k: np.array(v) for k, v in self.jframes(sl).items()})
        ts, loss, metrics = trainer.train_step(
            ts, self.topo, frames, normal=torch.tensor(np.array(normal)), with_metrics=True
        )
        return trainer, ts, float(loss), metrics


def assert_grads_close(params, jgrads, rtol=1e-4, atol=1e-5):
    """Every gradient within ``rtol`` and ``atol`` times its largest
    element of JAX's."""
    named = dict(jgrads.named_parameters())
    assert set(named) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        want = named[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=rtol, atol=atol * float(np.abs(want).max()), err_msg=name
        )


def assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            np.testing.assert_allclose(
                getattr(got[name], f).numpy(), np.asarray(getattr(ns, f)),
                rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(getattr(ns, f))).max()),
                err_msg=f"{name}.{f}",
            )
