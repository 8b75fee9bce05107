"""The port's pods (``parallel.multihost``) on the CPU: two ``gloo``
processes, each holding one row (a ``1 x 2`` share: its two local ranks
name the CPU twice) of a ``2 x 2`` pod, run the sharded forward and one
train step of the pod, held against the JAX package's
``make_spmd_train_step`` on a ``2 x 2`` mesh of virtual CPU devices and
against the port's in-process ``RankGroup(2, 2)`` forward and step; the
same pod with each process over two logical devices (``cpu:0``, ``cpu:1``:
a parameter copy on the second, its gradient summed in before the
processes' sum) against the in-process step over four; and the
single-process fallback (the counterpart of tests/test_aux.py's
``TestMultihost``).

Same weights (a JAX init whose normalizers have seen the trajectory, moved
by ``convert.state_from_jax_numpy``), 4 frames of the flat 10x10 synthetic
flag (float32, latent 32, 2 blocks, noise 0.003, gamma 0.9), split 2 and 2
over the processes; JAX's noise draw (its step's own key split) handed to
the port whole, each process cutting its rows.  The port runs ``agg_vjp:
fused`` (K1 raw and K2 per shard, their plain versions), the JAX reference
its ``gather`` path (one GSPMD program, no Pallas kernel).  Each worker
(tests/torch_port_multihost_worker.py) runs under a 60 s limit of its own.

Tolerances: the two processes' parameters, gradients and normalizers equal
bit for bit; the pod against the in-process forward and step: each
process's forward rows equal, equal loss, parameters after Adam within 1e-7
(the pod sums the data rows' partials in the same order; its gradients
cross the processes as float32 through the host), each gradient summed
over the pod within relative L2 1e-6 (GRAD_TOL: the largest reading is
6.9e-8, float32 rounding of a sum taken in another order), also for a
second step that draws its noise from a generator in each process;
against JAX: loss rtol 1e-5, parameters after one Adam step atol 1e-6,
normalizer states rtol 1e-5 (tests/test_torch_port_train.py's).
"""
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.parallel import multihost
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import make_sharded_forward, make_spmd_train_step, shard_topology
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import flag_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_multihost_worker.py")
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
NX, B, PROCESSES = 10, 4, 2
NOISE_SEED = 7  # the second step's generator, seeded alike in every process
GRAD_TOL = 1e-6  # each summed gradient's relative L2, pod against in-process


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """PyTorch's CPU operations on one thread for this module's tests (the
    port's small operations, not the JAX side's compiles): on a machine
    whose cores other test processes keep busy, each multi-threaded one
    waits at its barrier for threads that are not running
    (tests/test_torch_port_task.py's ``_one_cpu_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(agg_vjp):
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    return config


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    return params, {name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
                    for name, ns in state.normalizers.items()}


@functools.lru_cache(maxsize=None)
def _jax_start():
    """The JAX side's inputs: a JAX init whose normalizers have seen the
    trajectory (its train state, and numpy), the trajectory, the frames, the
    step's key and its noise draw."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)
    config = _config("gather")
    model = jax_get_model(config)
    trainer = JaxTrainer(model, config)
    tstate = jax.jit(trainer.init_train_state)(jax.random.PRNGKey(0))
    topo = model.topology_from_trajectory(traj)
    every = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}

    @jax.jit
    def accumulate(mstate):
        _, _, mstate = model.make_graph(mstate, topo, every, True)
        return model.get_target(mstate, every, True)[1]

    tstate = tstate.replace(model=accumulate(tstate.model))
    frames = {k: np.asarray(v[:B]) for k, v in traj.items() if k != "cells"}
    key = jax.random.PRNGKey(5)
    _, nkey, _ = jax.random.split(key, 3)
    normal = torch.from_numpy(np.array(jax.random.normal(nkey, frames["world_pos"].shape, jnp.float32)))
    return dict(traj=traj, model=model, trainer=trainer, topo=topo, tstate=tstate, key=key,
                start=_numpy_state(tstate.model), frames=frames, normal=normal)


def _jax_pod_step(j):
    """JAX's 2 x 2 sharded step from ``j``'s state: its loss, parameters
    (port names) and normalizers after one step."""
    mesh = jax_sharding.make_mesh(2, 2)
    step = jax_sharding.make_spmd_train_step(j["trainer"], jax_sharding.shard_topology(j["topo"], mesh), mesh)
    frames = {k: jnp.asarray(v) for k, v in j["frames"].items()}
    tstate = jax.tree.map(jnp.copy, j["tstate"])  # the step donates its state
    tstate, loss = step(tstate, jax_sharding.shard_frames(frames, mesh), j["key"])
    params, norms = _numpy_state(tstate.model)
    return float(loss), dict(state_from_jax_numpy(params, {}).params.named_parameters()), norms


def _in_process_step(j, devices=None):
    """The port's in-process RankGroup(2, 2) forward and step on the same
    inputs (on ``devices``, or every rank on the CPU)."""
    config = _config("fused")
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    topo = model.topology_from_trajectory(j["traj"], device="cpu")
    group = RankGroup(2, 2, device=None if devices else "cpu", devices=devices)
    stopo = shard_topology(topo, group)
    start = lambda: trainer.init_train_state(state=state_from_jax_numpy(*j["start"]))
    tstate = start()
    frames = trainer.frames(j["frames"])
    forward = make_sharded_forward(model, stopo, group)(tstate.model, frames)
    step = make_spmd_train_step(trainer, stopo, group)
    tstate, loss = step(tstate, frames, normal=j["normal"])
    drawn, _ = step(start(), frames, generator=torch.Generator().manual_seed(NOISE_SEED))
    return (forward, float(loss), dict(tstate.model.params.named_parameters()), tstate.model.normalizers,
            dict(drawn.model.params.named_parameters()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_pod(j, tmp_path, spread=False):
    """The two workers, started (each writes its results to its file;
    ``spread``: each over two logical devices)."""
    src = str(tmp_path / "case.pt")
    torch.save(dict(config=_config("fused"), trajectory=j["traj"], frames=j["frames"], normal=j["normal"],
                    numpy_state=j["start"], noise_seed=NOISE_SEED), src)
    port = _free_port()
    outs = [str(tmp_path / f"out{r}.pt") for r in range(PROCESSES)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(PROCESSES), str(port), src, outs[r]]
                              + (["spread"] if spread else []),
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PROCESSES)]
    return procs, outs


def _join_pod(procs, outs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("pod workers past their 60 s limit:\n" + "\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r}:\n{log[-3000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def test_two_process_pod_step_matches_jax_and_the_in_process_step(tmp_path):
    j = _jax_start()
    procs, outs = _start_pod(j, tmp_path)
    try:  # the references while the workers run
        jax_loss, jax_params, jax_norms = _jax_pod_step(j)
        forward, loss, params, norms, drawn = _in_process_step(j)
    finally:
        results = _join_pod(procs, outs)
    # each process: one row of the 2 x 2 pod
    for r, res in enumerate(results):
        shape, data_size, processes, process = res["layout"]
        assert shape == {"data": 2, "graph": 2} and data_size == 2 and (processes, process) == (2, r)
        assert res["rows"] == B // 2
        assert res["processes"] == (2, r)
    # trajectories dealt round-robin, disjoint, every one dealt
    a, b = results[0]["trajectories"], results[1]["trajectories"]
    assert a == [0, 2, 4, 6, 8] and b == [1, 3, 5, 7, 9]
    # the two processes hold the same bits
    p0, p1 = results
    assert torch.equal(p0["loss"], p1["loss"])
    for key in ("params", "grads", "params_drawn", "grads_drawn"):
        for n in p0[key]:
            assert torch.equal(p0[key][n], p1[key][n]), (key, n)
    for k in p0["normalizers"]:
        for f in NORMALIZER_FIELDS:
            assert torch.equal(p0["normalizers"][k][f], p1["normalizers"][k][f]), (k, f)
    # against the in-process 2 x 2 forward (each process its rows) and step
    for r, res in enumerate(results):
        assert torch.equal(res["forward"], forward[r * B // 2 : (r + 1) * B // 2]), r
    assert float(p0["loss"]) == loss
    for n, p in params.items():
        torch.testing.assert_close(p0["params"][n], p.detach(), rtol=0, atol=1e-7, msg=n)
    # the gradients summed over the pod before Adam, and a second step whose
    # noise each process draws whole from a generator seeded alike and cuts
    # at its own rows (Adam's first update hardly moves with the gradients'
    # size, so the gradients are held as well as the parameters)
    for key, ps in (("grads", params), ("grads_drawn", drawn)):
        for n, p in ps.items():
            assert float((p0[key][n] - p.grad).norm()) <= GRAD_TOL * float(p.grad.norm()), (key, n)
    for n, p in drawn.items():
        torch.testing.assert_close(p0["params_drawn"][n], p.detach(), rtol=0, atol=1e-7, msg=n)
    for k, ns in norms.items():
        for f in NORMALIZER_FIELDS:
            assert torch.equal(p0["normalizers"][k][f], getattr(ns, f)), (k, f)
    # against JAX's 2 x 2 step
    np.testing.assert_allclose(float(p0["loss"]), jax_loss, rtol=1e-5)
    for n, w in jax_params.items():
        np.testing.assert_allclose(p0["params"][n].numpy(), w.detach().numpy(), rtol=0, atol=1e-6, err_msg=n)
    for k, ns in jax_norms.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(ns[f])
            np.testing.assert_allclose(p0["normalizers"][k][f].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=f"{k}.{f}")


def test_two_process_pod_over_two_devices_each_is_bit_for_bit_across_processes(tmp_path):
    """Each process's group over two logical devices (``cpu:0``, ``cpu:1``,
    as a process with two cards holds it): the step keeps a parameter copy
    on ``cpu:1`` and sums the two devices' gradients before the processes'
    sum.  The processes equal bit for bit, each copy equals its process's
    parameters bit for bit after the step, and the pod stays within the
    module's limits (loss equal up to float32 rounding, rtol 1e-6;
    parameters atol 1e-7; each gradient's relative L2 within GRAD_TOL) of
    the in-process step over four logical devices, whose gradients sum in
    another order."""
    j = _jax_start()
    procs, outs = _start_pod(j, tmp_path, spread=True)
    try:
        forward, loss, params, _, drawn = _in_process_step(j, devices=[torch.device("cpu", d) for d in range(4)])
    finally:
        results = _join_pod(procs, outs)
    p0, p1 = results
    for r, res in enumerate(results):
        assert res["devices"] == ["cpu:0", "cpu:1"] and list(res["copies"]) == ["cpu:1"]
        for n, c in res["copies"]["cpu:1"].items():  # the last step's parameters
            assert torch.equal(c, res["params_drawn"][n]), n
        assert torch.equal(res["forward"], forward[r * B // 2 : (r + 1) * B // 2]), r
    assert torch.equal(p0["loss"], p1["loss"])
    for key in ("params", "grads", "params_drawn", "grads_drawn"):
        for n in p0[key]:
            assert torch.equal(p0[key][n], p1[key][n]), (key, n)
    np.testing.assert_allclose(float(p0["loss"]), loss, rtol=1e-6)
    for n, p in params.items():
        torch.testing.assert_close(p0["params"][n], p.detach(), rtol=0, atol=1e-7, msg=n)
    for key, ps in (("grads", params), ("grads_drawn", drawn)):
        for n, p in ps.items():
            assert float((p0[key][n] - p.grad).norm()) <= GRAD_TOL * float(p.grad.norm()), (key, n)


# -- a pod of one process ------------------------------------------------------------


def test_pod_group_of_one_process_is_the_local_group():
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    group = multihost.make_pod_group(graph_per_host=2, device="cpu")
    assert group.shape == {"data": 1, "graph": 2} and group.data_size == 1
    assert (group.processes, group.process, group.process_group) == (1, 0, None)
    assert group.devices == [torch.device("cpu")] * 2
    assert multihost.make_pod_group(device="cpu").shape == {"data": 1, "graph": 1}


def test_host_local_batch_of_one_process_is_the_whole_batch():
    group = multihost.make_pod_group(graph_per_host=2, device="cpu")
    batch = multihost.host_local_batch_to_global({"x": np.ones((4, 3, 2), np.float32)}, group)
    assert batch["x"].shape == (4, 3, 2) and batch["x"].device == group.device(0)
    assert (group.processes, group.process) == (1, 0)  # the step's rows: 0 .. 4 of 4
    x = torch.arange(6.0)
    assert group.gather_processes(x)[0] is x


def test_trajectory_round_robin_of_one_process_gets_everything():
    assert list(multihost.host_trajectory_indices(10)) == list(range(10))
