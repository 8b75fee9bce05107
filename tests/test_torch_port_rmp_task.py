"""The task loop with remote message passing, port against the JAX package:
``MeshSimulator`` fit and evaluators on configs/hyper_demo.yaml at a tiny
size, a task epoch and its resume, and a JAX checkpoint with hyper weights
served by the port.

Size: hyper_demo's settings (spectral clustering, ``connector: hyper``,
``agg_vjp: fused``, reset every trajectory) cut to an 8x8 flag of 12 frames
(10 training frames a trajectory), 4 clusters, latent 32, 2 blocks,
float32, batch 4 (batches of 4, 4 and 2 frames).  The port starts from the
JAX simulator's state, and its noise is JAX's: per batch the field's draw
and the cluster means' (``trainer.py:159``, ``expansion.py:78-84``).

Tolerances as tests/test_torch_port_task.py: losses and evaluator scalars
rtol 1e-5; parameters after the epoch atol 1e-6, normalizer states rtol
1e-5 and 1e-5 of the field's largest magnitude; rollout positions rtol
1e-5, atol 1e-6.  One exception, after the epoch: an element whose gradient
at any of the 3 Adam steps lies within 10 eps (1e-7) of 0.  There a step is
``lr * m / (sqrt(v) + eps)`` with ``m`` and ``v`` of a float32 summation
residue, so each step can move it by up to lr either way in either package
(the sparse cluster-tier sets have many small gradients: 12 inter edges
for 4 clusters); such elements are held to 3 lr, and at most 10 elements
of the 117,635 may be off by more than 1e-6 (measured: 3, the largest
3.6e-5 = 0.36 lr).  A checkpoint served by the port is bit for bit the converted
state's prediction.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
from hyper_graph_nets_tpu.training.simulator import MeshSimulator as JaxMeshSimulator
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy, train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training import checkpoint
from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
from hyper_graph_nets_tpu_torch.training.task import get_task
from hyper_graph_nets_tpu_torch.utils.config import read_yaml
from test_torch_port_task import NORMALIZER_FIELDS, _assert_state_close, _jax_numpy

N_TIMESTEPS, N_STEP = 10, 3
LR, ADAM_EPS = 1e-4, 1e-8


def _config():
    config = read_yaml("hyper_demo")
    params = config["params"]
    params["task"].update(
        batch_size=4, epochs=1, n_timesteps=N_TIMESTEPS, trajectories=1,
        synthetic={"trajectories": 2, "num_steps": 12, "nx": 8, "ny": 8},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": N_STEP},
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
    )
    params["model"].update(latent_size=32, message_passing_steps=2, compute_dtype=None)
    params["model"]["rmp"]["num_clusters"] = 4
    return config


def jax_rmp_noise(key):
    """A stand-in for ``MeshSimulator._normal`` that returns the JAX
    simulator's draws from ``key`` on: for each batch the field's, then the
    cluster means' (RMP, the only expansion member)."""
    state = {"key": key, "ekey": None}

    def normal(shape):
        if state["ekey"] is None:
            state["key"], k = jax.random.split(state["key"])
            _, nkey, state["ekey"] = jax.random.split(k, 3)
            return torch.from_numpy(np.array(jax.random.normal(nkey, tuple(shape), jnp.float32)))
        _, sub = jax.random.split(state["ekey"])
        state["ekey"] = None
        return torch.from_numpy(np.array(jax.random.normal(sub, tuple(shape), jnp.float32)))

    return normal


class _Fitted:
    def __init__(self, root):
        self.config = _config()
        self.data_dir = str(root / "data")
        self.jsim = JaxMeshSimulator(self.config, out_dir=str(root / "jax_out"))
        jts = self.jsim.initialize()
        self.sim = MeshSimulator(self.config, out_dir=str(root / "port_out"), device="cpu")
        self.sim.initialize()
        ts = train_state_from_jax_numpy(self.sim.trainer, *_jax_numpy(jts))
        self.sim._normal = jax_rmp_noise(self.jsim._key)
        self.tiny = {}  # elements whose gradient was within 10 eps of 0 at some step
        loss_and_grads = self.sim.trainer.loss_and_grads

        def recording(tstate, *args, **kwargs):
            out = loss_and_grads(tstate, *args, **kwargs)
            for n, p in tstate.model.params.named_parameters():
                tiny = p.grad.abs() < 10 * ADAM_EPS
                self.tiny[n] = tiny | self.tiny.get(n, torch.zeros_like(tiny))
            return out

        self.sim.trainer.loss_and_grads = recording
        traj = next(iter(self.data("train")))
        self.jts, self.jlosses = self.jsim.fit_trajectory(jts, traj)
        self.ts, self.losses = self.sim.fit_trajectory(ts, traj)

    def data(self, split):
        return jax_get_data(self.config, split, data_dir=self.data_dir)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    return _Fitted(tmp_path_factory.mktemp("rmp_fit"))


def test_rmp_fit_trajectory_matches_jax(fitted):
    """Losses of the three batches (each prepared on its first frame, the
    batch order shuffled) and the state after them."""
    assert len(fitted.losses) == 3
    np.testing.assert_allclose(fitted.losses, fitted.jlosses, rtol=1e-5)
    want = state_from_jax_numpy(*_jax_numpy(fitted.jts)[:2])
    wparams = dict(want.params.named_parameters())
    loose = 0
    for name, p in fitted.ts.model.params.named_parameters():
        atol = torch.full_like(p, 1e-6)
        atol[fitted.tiny[name]] = 3 * LR
        err = (p.detach() - wparams[name].detach()).abs()
        assert bool((err <= atol).all()), (name, float(err.max()))
        loose += int((err > 1e-6).sum())
    assert loose <= 10, loose
    for name, ns in want.normalizers.items():
        for f in NORMALIZER_FIELDS:
            w = getattr(ns, f).numpy()
            np.testing.assert_allclose(getattr(fitted.ts.model.normalizers[name], f).numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}.{f}")
    assert fitted.ts.step == int(fitted.jts.step) == 3
    assert {"intra_edge", "inter_edge", "hyper_node"} <= set(fitted.ts.model.normalizers)


def test_rmp_evaluators_match_jax(fitted):
    got = fitted.sim.one_step_evaluator(fitted.ts, fitted.data("valid"), n_trajectories=1)
    want = fitted.jsim.one_step_evaluator(fitted.jts, fitted.data("valid"), n_trajectories=1)
    for k in ("validation_loss", "position_error"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    got = fitted.sim.rollout_evaluator(fitted.ts, fitted.data("valid"), n_rollouts=1, num_steps=N_TIMESTEPS)
    want = fitted.jsim.rollout_evaluator(fitted.jts, fitted.data("valid"), n_rollouts=1, num_steps=N_TIMESTEPS)
    np.testing.assert_allclose(got["mse_curve"], want["mse_curve"], rtol=1e-5)
    np.testing.assert_allclose(
        got["rollouts"][0]["pred_pos"], np.asarray(want["rollouts"][0]["pred_pos"]), rtol=1e-5, atol=1e-6
    )
    got = fitted.sim.n_step_evaluator(fitted.ts, fitted.data("valid"), n_step=N_STEP, n_trajectories=1,
                                      num_timesteps=N_TIMESTEPS)
    want = fitted.jsim.n_step_evaluator(fitted.jts, fitted.data("valid"), n_step=N_STEP, n_trajectories=1,
                                        num_timesteps=N_TIMESTEPS)
    for k in ("n_step_loss", "n_step_last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_cluster_image_or_labels(fitted, tmp_path):
    """``visualize_clusters``: a PNG when matplotlib imports, else the last
    clustering's labels (4 clusters over the 64 nodes)."""
    out = fitted.sim.visualize_clusters(str(tmp_path / "clusters.png"))
    if isinstance(out, str):
        assert os.path.isfile(out)
    else:
        assert out.shape == (64,) and set(np.unique(out)) == set(range(4))


def test_jax_checkpoint_with_hyper_weights_is_served(fitted, tmp_path):
    """A checkpoint the JAX package wrote after the fit (hyper encoder,
    hierarchical node models, the RMP normalizers) loads into the port and
    its trainer; ``Predictor.from_config`` serves it bit for bit as the
    converted state."""
    path = jax_checkpoint.save(str(tmp_path), fitted.config, fitted.jts, 1)
    ts, epoch, _ = checkpoint.load(path, fitted.sim.trainer)
    assert epoch == 1 and ts.model.params.hyper_encoder is not None
    _assert_state_close(ts, fitted.jts)
    traj = next(iter(fitted.data("test")))
    served = Predictor.from_config(fitted.config, checkpoint=path, device="cpu").one_step(traj)
    state = state_from_jax_numpy(*_jax_numpy(fitted.jts)[:2])
    assert np.array_equal(served, Predictor(fitted.config, state=state, device="cpu").one_step(traj))


def test_rmp_task_epoch_and_resume(tmp_path, monkeypatch):
    """A task on the tiny hyper_demo trains an epoch (finite scalars, a
    checkpoint holding the RMP normalizers, a cluster image or labels); a
    second task on the directory resumes at epoch 1 and trains nothing, and
    the served checkpoint predicts bit for bit what the task's state does."""
    config = _config()
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.run_iterations()
    scalars = task.get_scalars()
    assert all(np.isfinite(v) for v in scalars.values()) and len(scalars) == 4
    path = os.path.join(task.out_dir, checkpoint.checkpoint_name(config, 1))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert {"intra_edge", "inter_edge", "hyper_node"} <= set(payload["normalizers"])

    again = get_task(config, data_dir=str(tmp_path), device="cpu")
    assert again.start_epoch == 1
    monkeypatch.setattr(again.simulator, "fit_trajectory", lambda *a, **k: pytest.fail("trained"))
    again.run_iterations()
    traj = next(iter(jax_get_data(config, "test", data_dir=str(tmp_path))))
    served = Predictor.from_config(config, checkpoint=task.out_dir, device="cpu").one_step(traj)
    assert np.array_equal(served, Predictor(config, state=task.tstate.model, device="cpu").one_step(traj))
