"""Bucketing of the port against the JAX package's, through the task loop
and on plate: the real-schema fixture (``tests/test_real_schema.py``:
flag_simple, ``meta.json`` with ``-1`` node dims, meshes of 36, 35 and 35
nodes) with ``capacity.json`` written by one package and read by the
other, and a 5x5 and a 6x5 plate under ``max_world_edges: auto``.

Both packages start from one state whose normalizers sit at their
accumulation cap and the port trains with JAX's noise draws
(``test_torch_port_bucketing._pair``, whose docstring says why).
Tolerances, float32: losses and scalars rtol 1e-5; indices, masks,
capacities and counts equal.  The rollout GIFs are not drawn (both tasks'
``animate_rollout`` is replaced): nothing here reads them.
"""
import json
import os

import numpy as np
import pytest

from hyper_graph_nets_tpu.training import task as jax_task_module
from hyper_graph_nets_tpu.training.task import MeshTask as JaxMeshTask
from hyper_graph_nets_tpu_torch.convert import train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.training import task as task_module
from hyper_graph_nets_tpu_torch.training.task import get_task
from test_torch_port_bucketing import N_TIMESTEPS, PLATE_TIMESTEPS, _assert_topology_equal, _capped, _config, _pair, _plate, _plate_config
from test_torch_port_task import _jax_numpy, jax_noise


@pytest.fixture(autouse=True)
def no_gifs(monkeypatch):
    for module in (jax_task_module, task_module):
        monkeypatch.setattr(module, "animate_rollout", lambda *a, **k: None)


# -- plate ----------------------------------------------------------------------


def test_plate_auto_world_capacity_over_two_sizes(tmp_path):
    """A 5x5 and a 6x5 plate under ``max_world_edges: auto`` (2 blocks,
    latent 16): the bucket dims (obstacle capacity, world-capacity floor),
    each topology (obstacle indices at the bucket's capacity, world
    capacity floored at the bucket's), the fit's losses and the evaluators'
    scalars and truncation counts equal JAX's."""
    trajs = [_plate(5, 5), _plate(6, 5, seed=1)]
    jsim, jts, sim, ts = _pair(_plate_config(), tmp_path, trajs)
    assert sim._topo_extras == jsim._topo_extras and sim._topo_extras["world_floor"] >= 64
    for traj in trajs:
        _assert_topology_equal(sim._topology(sim._prepare(traj)), jsim._topology(jsim._prepare(traj)))
        jts, jl = jsim.fit_trajectory(jts, traj)
        ts, lo = sim.fit_trajectory(ts, traj)
        np.testing.assert_allclose(lo, jl, rtol=1e-5)
    for traj in trajs:
        jsim.model._fn_cache.clear()  # see test_jax_bucketed_rollout_reuses_its_first_mesh
        got = sim.rollout_evaluator(ts, [traj], num_steps=PLATE_TIMESTEPS, logging=False, save=False)
        want = jsim.rollout_evaluator(jts, [traj], num_steps=PLATE_TIMESTEPS, logging=False, save=False)
        np.testing.assert_allclose(got["rollout_loss"], want["rollout_loss"], rtol=1e-5)
        assert got["world_edge_truncated"] == want["world_edge_truncated"]
        got = sim.one_step_evaluator(ts, [traj], logging=False)
        want = jsim.one_step_evaluator(jts, [traj], logging=False)
        np.testing.assert_allclose(got["validation_loss"], want["validation_loss"], rtol=1e-5)
        assert got["world_edge_truncated"] == want["world_edge_truncated"]


# -- the task loop -------------------------------------------------------------------


def _schema_config(agg_vjp):
    config = _config(agg_vjp, dataset="flag_simple")
    task = config["params"]["task"]
    task.update(trajectories=3, n_timesteps=N_TIMESTEPS)
    return config


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_task_loop_on_the_real_schema_matches_jax(tmp_path, writer):
    """The real-schema fixture (flag_simple, ``-1`` node dims, meshes of 36,
    35 and 35 nodes): the task of one package writes ``capacity.json`` and
    the other's reads it, every key the same as a scan of its own; both
    tasks pad to 36 nodes, run an epoch (3 trajectories, the ``xla`` path:
    the fused one is held above, JAX's state and noise) and give the same
    ``get_scalars``."""
    from test_real_schema import _write_fixture

    _write_fixture(tmp_path)
    config = _schema_config("xla")
    cache = tmp_path / "flag_simple" / "input" / "capacity.json"
    # the JAX task reads config["model"] when the sizes vary
    # (training/task.py:137): it takes the params section itself
    make_jax = lambda: JaxMeshTask(config["params"], data_dir=str(tmp_path))
    make_port = lambda: get_task(config, data_dir=str(tmp_path), device="cpu")
    first, second = (make_port, make_jax) if writer == "port" else (make_jax, make_port)
    a = first()
    written = json.loads(cache.read_text())
    assert written == {"variable": True, "max_nodes": 36, "max_edges": 170}
    b = second()
    assert json.loads(cache.read_text()) == written
    jtask, task = (b, a) if writer == "port" else (a, b)
    assert task.simulator.capacity == jtask.simulator.capacity == (36, 170)
    assert task.simulator._plan_dims == jtask.simulator._plan_dims
    jtask.tstate = _capped(jtask.simulator.model, jtask.tstate, next(iter(jtask._train_data())))
    task.tstate = train_state_from_jax_numpy(task.simulator.trainer, *_jax_numpy(jtask.tstate))
    task.simulator._normal = jax_noise(jtask.simulator._key)
    jtask.run_iterations()
    task.run_iterations()
    # JAX's compiled rollouts are keyed by shape (see
    # test_jax_bucketed_rollout_reuses_its_first_mesh): clear them before
    # the test split's mesh
    jtask.simulator.model._fn_cache.clear()
    got, want = task.get_scalars(), jtask.get_scalars()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert os.path.isfile(os.path.join(task.out_dir, "rollouts.pkl"))
