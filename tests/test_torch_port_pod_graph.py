"""The port's pod laid out as the JAX package lays it out
(``parallel.multihost.make_pod_group`` against ``make_pod_mesh``), with a
``graph`` row across processes, on the CPU.

- The layout: ``make_pod_group``'s shape, each process's ranks and its idle
  ranks against ``make_pod_mesh`` (unchanged; its ``process_count``,
  ``local_device_count`` and ``devices`` monkeypatched over
  tests/conftest.py's 8 host devices, the port's ``process_count`` and
  ``process_index`` stubbed), for (processes, local devices, graph) =
  (2, 1, 2), (1, 4, 3), (2, 2, 4), (2, 3, 2), (2, 2, 2), (4, 1, 2).
- Two ``gloo`` processes of one rank each form a ``1 x 2`` pod, the
  ``graph`` row across them: flag 10x10 (latent 32, 2 blocks, float32)
  with ``agg_vjp: fused`` (K1 raw per shard, the plain all-reduce across
  the processes, K2 per shard in each process's sharded node) and
  ``sorted`` (the row's shards joined across the processes, K4f/K4b on
  them), flag with RMP (``connector: hyper``, spectral K = 4: the tier
  sets' unfused sums cross too) and ``cylinder.yaml`` cut to latent 16 and
  2 blocks; one train step and the sharded forward each.  Two processes of
  two logical devices each (``cpu:0``, ``cpu:1``) form a ``1 x 4`` pod
  (fused flag).
- A planted control: each process's sharded nodes drop the other
  process's aggregate cotangents (``RankGroup.cotangents`` returning the
  process's own).
- K7's layout, the halo forward's ring, the ring aggregate and K6 on the
  row across processes raise, naming ROADMAP entry 7.4c.

Tolerances: against the in-process group of the same shape
(``RankGroup(1, 2)`` on the CPU, ``RankGroup(1, 4)`` over four logical
devices) the loss, every gradient, the parameters after Adam, the
normalizer states and the forward rows equal bit for bit in each process
(the same plain kernels on the same shards, every fold in global rank
order, the gradients summed over the devices of every process in global
order); against JAX's sharded step on ``make_mesh(1, 2)`` (its ``gather``
path, as tests/test_torch_port_multihost.py's) the loss within rtol 1e-5
and the parameters after one Adam step within atol 1e-6.  The control must
move the worst gradient past ``CONTROL_MIN`` relative L2 (it reads about
0.59), far past float32 rounding.  Each worker runs under a
``communicate`` limit of ``WORKER_TIMEOUT_S`` and a process-group limit of
60 s (tests/torch_port_pod_graph_worker.py).
"""
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.parallel import multihost as jax_multihost
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.data import synthetic
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.parallel import multihost
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology
from torch_port_cases import flag_config
from torch_port_models import cut_config
import torch_port_pod_graph_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_pod_graph_worker.py")
NX, B, K = 10, 4, 4
PROCESSES = 2
WORKER_TIMEOUT_S = 150
CONTROL_MIN = 1e-2
LAYOUTS = [(2, 1, 2), (1, 4, 3), (2, 2, 4), (2, 3, 2), (2, 2, 2), (4, 1, 2)]
ROW_CASES = ("flag_fused", "flag_sorted", "rmp", "cylinder")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """PyTorch's CPU operations on one thread for this module's tests
    (tests/test_torch_port_multihost.py's ``_one_cpu_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the layout --------------------------------------------------------------------------


@pytest.mark.parametrize("processes, n_local, graph", LAYOUTS, ids=[f"P{p}-n{n}-g{g}" for p, n, g in LAYOUTS])
def test_pod_layout_is_make_pod_mesh(processes, n_local, graph, monkeypatch):
    """Each process's share of the pod: the shape, the process's global
    ranks (their places in JAX's mesh, row-major) and its idle ranks (its
    devices JAX leaves out of ``devices[: data * graph]``), each rank on the
    local device of its place in the process."""
    devices = jax.devices()[: processes * n_local]
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    monkeypatch.setattr(jax, "local_device_count", lambda: n_local)
    monkeypatch.setattr(jax, "devices", lambda: devices)
    mesh = jax_multihost.make_pod_mesh(graph)
    placed = list(np.asarray(mesh.devices).reshape(-1))
    monkeypatch.setattr(multihost, "process_count", lambda: processes)
    local_devices = [torch.device("cpu", i) for i in range(n_local)]
    for p in range(processes):
        monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
        group = multihost.make_pod_group(graph_per_host=graph, devices=local_devices)
        local = devices[p * n_local : (p + 1) * n_local]
        assert (group.shape["data"], group.shape["graph"]) == mesh.devices.shape, p
        assert group.ranks == [placed.index(d) for d in local if d in placed], p
        assert group.idle == [p * n_local + i for i, d in enumerate(local) if d not in placed], p
        assert group.devices == [local_devices[q - p * n_local] for q in group.ranks], p
        assert (group.process, group.data_rows) == (p, sorted({q // graph for q in group.ranks})), p


def test_pod_of_one_process_keeps_its_round_robin_extension():
    """One process, ``graph`` above its ranks: JAX's mesh would be empty;
    the port's ranks share the devices round-robin."""
    group = multihost.make_pod_group(graph_per_host=3, devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
    assert group.shape == {"data": 1, "graph": 3} and group.ranks == [0, 1, 2] and group.idle == []
    assert group.devices == [torch.device("cpu", i) for i in (0, 1, 0)]


# -- the cases -------------------------------------------------------------------------------


def _flag_config(agg_vjp, rmp=False):
    config = flag_config(None, agg_vjp=agg_vjp)
    model = config["params"]["model"]
    model.update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    if rmp:
        model["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": K,
                        "hyper_noise": 0.005, "hyper_node_features": True, "frequency": 1}
    return config


@functools.lru_cache(maxsize=None)
def _jax_start():
    """JAX's ``gather`` flag model, a state whose normalizers have seen the
    trajectory, the trajectory, the frames, the step's key and its noise
    draw (tests/test_torch_port_multihost.py's)."""
    traj = jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)
    config = _flag_config("gather")
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
    return dict(traj=traj, trainer=trainer, topo=topo, tstate=tstate, key=key, frames=frames, normal=normal)


def _jax_row_step():
    """JAX's sharded step on ``make_mesh(1, 2)`` from ``_jax_start``'s
    state: its loss and parameters (port names) after one step."""
    j = _jax_start()
    mesh = jax_sharding.make_mesh(1, 2)
    step = jax_sharding.make_spmd_train_step(j["trainer"], jax_sharding.shard_topology(j["topo"], mesh), mesh)
    frames = {k: jnp.asarray(v) for k, v in j["frames"].items()}
    tstate = jax.tree.map(jnp.copy, j["tstate"])  # the step donates its state
    tstate, loss = step(tstate, jax_sharding.shard_frames(frames, mesh), j["key"])
    params = jax.tree.map(np.asarray, tstate.model.params)
    return float(loss), dict(state_from_jax_numpy(params, {}).params.named_parameters())


def _port_state(config, traj, state=None):
    """The case's parameters and normalizers: ``state`` (a port state), or
    the port's seeded init."""
    if state is None:
        state = get_model(config).init_state(torch.Generator().manual_seed(0))
    return dict(params={n: p.detach().clone() for n, p in state.params.named_parameters()},
                normalizers=state.normalizers)


@functools.lru_cache(maxsize=None)
def _cases():
    """Each case of the ``1 x 2`` pod: config, trajectory, frames, noise
    draws and state."""
    j = _jax_start()
    jparams = jax.tree.map(np.asarray, j["tstate"].model.params)
    jnorms = {name: {f: np.asarray(getattr(ns, f)) for f in worker.NORMALIZER_FIELDS}
              for name, ns in j["tstate"].model.normalizers.items()}
    flag_state = state_from_jax_numpy(jparams, jnorms)
    cases = {}
    for agg_vjp in ("fused", "sorted"):
        config = _flag_config(agg_vjp)
        cases[f"flag_{agg_vjp}"] = dict(config=config, trajectory=j["traj"], frames=j["frames"], normal=j["normal"],
                                        **_port_state(config, j["traj"], flag_state))
    cases["flag_fused"].update(control=True, raises=True)

    gen = torch.Generator().manual_seed(3)
    traj = add_targets(synthetic.flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", history=True)
    config = _flag_config("fused", rmp=True)
    frames = {k: v[:B] for k, v in traj.items() if k != "cells"}
    cases["rmp"] = dict(config=config, trajectory=traj, frames=frames,
                        normal=torch.randn(frames["world_pos"].shape, generator=gen),
                        hyper=torch.randn((B, K, 5), generator=gen), **_port_state(config, traj))

    traj = add_targets(synthetic.cylinder_trajectory(num_steps=B + 2, nx=7, ny=5, seed=1), "velocity", False)
    config = cut_config("cylinder")
    frames = {k: v[:B] for k, v in traj.items() if k != "cells"}
    cases["cylinder"] = dict(config=config, trajectory=traj, frames=frames,
                             normal=torch.randn(frames["velocity"].shape, generator=gen),
                             **_port_state(config, traj))
    return cases


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp, name, job):
    src = os.path.join(tmp, f"{name}.pt")
    torch.save(job, src)
    port = _free_port()
    outs = [os.path.join(tmp, f"{name}{r}.pt") for r in range(PROCESSES)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(PROCESSES), str(port), src, outs[r]],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PROCESSES)]
    return procs, outs


def _join(procs, outs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"pod workers past their {WORKER_TIMEOUT_S} s limit:\n" + "\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r}:\n{log[-3000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Both pods' results (``row``: the ``1 x 2`` cases, ``wide``: the
    ``1 x 4`` one), the in-process references and JAX's ``1 x 2`` step,
    the references computed while the workers run."""
    tmp = str(tmp_path_factory.mktemp("pod_graph"))
    cases = _cases()
    wide_devices = [["cpu:0", "cpu:1"]] * PROCESSES
    started = [_start(tmp, "row", dict(graph=2, devices=[["cpu"]] * PROCESSES, cases=cases)),
               _start(tmp, "wide", dict(graph=4, devices=wide_devices, cases={"flag_fused": cases["flag_fused"]}))]
    try:
        refs = {name: worker.run_case(dict(case, control=False, raises=False),
                                      lambda: RankGroup(1, 2, device="cpu")) for name, case in cases.items()}
        wide_ref = worker.run_case(dict(cases["flag_fused"], control=False, raises=False),
                                   lambda: RankGroup(1, 4, devices=[torch.device("cpu", i) for i in range(4)]))
        jax_ref = _jax_row_step()
    finally:
        row, wide = (_join(*s) for s in started)
    return dict(row=row, wide=wide, refs=refs, wide_ref=wide_ref, jax=jax_ref)


def _assert_bit_for_bit(got, want, what):
    assert torch.equal(got["loss"], want["loss"]), what
    assert torch.equal(got["forward"], want["forward"]), what
    for key in ("grads", "params"):
        for n, w in want[key].items():
            assert torch.equal(got[key][n], w), (what, key, n)
    for k, fields in want["normalizers"].items():
        for f, w in fields.items():
            assert torch.equal(got["normalizers"][k][f], w), (what, k, f)


@pytest.mark.parametrize("name", ROW_CASES)
def test_graph_row_across_processes_is_bit_for_bit_with_the_in_process_group(pods, name):
    """Each process of the ``1 x 2`` pod holds one rank of the one ``graph``
    row; its loss, gradients, parameters after Adam, normalizers and
    forward rows equal the in-process ``RankGroup(1, 2)``'s bit for bit."""
    for p, res in enumerate(pods["row"]):
        got = res[name]
        assert got["layout"]["shape"] == {"data": 1, "graph": 2} and got["layout"]["ranks"] == [p]
        assert got["layout"]["rows"] == [0] and (got["layout"]["process"], got["layout"]["processes"]) == (p, 2)
        _assert_bit_for_bit(got, pods["refs"][name], (name, p))


def test_graph_row_over_two_processes_of_two_devices_is_bit_for_bit(pods):
    """Two processes of two logical devices each: a ``1 x 4`` pod whose row
    spans both, bit for bit with the in-process ``RankGroup(1, 4)`` over four
    logical devices (the devices' gradients summed in one global order)."""
    for p, res in enumerate(pods["wide"]):
        got = res["flag_fused"]
        assert got["layout"]["shape"] == {"data": 1, "graph": 4}
        assert got["layout"]["ranks"] == [2 * p, 2 * p + 1] and got["layout"]["devices"] == ["cpu:0", "cpu:1"]
        _assert_bit_for_bit(got, pods["wide_ref"], p)


@pytest.mark.parametrize("name", ("flag_fused", "flag_sorted"))
def test_graph_row_across_processes_matches_jax(pods, name):
    """The pod against JAX's sharded step on ``make_mesh(1, 2)``: the loss
    within rtol 1e-5, the parameters after Adam within atol 1e-6."""
    jax_loss, jax_params = pods["jax"]
    for res in pods["row"]:
        np.testing.assert_allclose(float(res[name]["loss"]), jax_loss, rtol=1e-5)
        for n, w in jax_params.items():
            np.testing.assert_allclose(res[name]["params"][n].numpy(), w.detach().numpy(), rtol=0, atol=1e-6,
                                       err_msg=n)


def test_dropping_the_other_process_cotangents_misses_the_gradients(pods):
    """The planted control: with each sharded node's backward summing only
    its own process's aggregate cotangents, the loss stays (the forward is
    whole) and the worst gradient misses the in-process one by more than
    CONTROL_MIN relative L2."""
    want = pods["refs"]["flag_fused"]
    for res in pods["row"]:
        got = res["flag_fused"]
        assert torch.equal(got["control_loss"], want["loss"])
        worst = max(float((got["control_grads"][n] - g).norm() / g.norm()) for n, g in want["grads"].items())
        assert worst > CONTROL_MIN, worst


def test_ring_kernels_on_a_row_across_processes_raise(pods):
    """K7's layout (``shard_topology(overlap_bands=4)``), the halo forward's
    ring, the ring aggregate and K6 on the row across processes raise
    ``NotImplementedError`` naming ROADMAP entry 7.4c; in one process the
    same group shape takes K7's layout as before."""
    for res in pods["row"]:
        errors = res["flag_fused"]["ring_errors"]
        assert set(errors) == {"overlap_layout", "halo_ring", "ring_aggregate", "ring_all_reduce"}
        for name, msg in errors.items():
            assert msg is not None and "7.4c" in msg, (name, msg)
    case = _cases()["flag_fused"]
    model = get_model(case["config"])
    topo = model.topology_from_trajectory(case["trajectory"], device="cpu")
    stopo = shard_topology(topo, RankGroup(1, 2, device="cpu"), overlap_bands=4)
    assert stopo.plan.plans[0].overlap_bands == 4
