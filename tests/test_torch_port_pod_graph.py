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
- The ring kernels along rows across processes (their plain versions, the
  other processes' partials gathered), in three pods of (processes, local
  ranks, graph) = (2, 1, 2) (1 x 2), (2, 2, 4) (1 x 4) and (4, 1, 2)
  (2 x 2, four more worker processes): K6, the ring aggregate, K7's
  layout, the halo forward with ``ring`` (``agg_vjp: xla``, K6) and with
  ``overlap`` (fused, 4 bands, K7) on frame 0, and one overlap-banded
  train step.  A card group whose row spans two nodes raises naming
  ROADMAP entry 7.4d.

Tolerances: against the in-process group of the same shape
(``RankGroup(1, 2)`` on the CPU, ``RankGroup(1, 4)`` over four logical
devices) the loss, every gradient, the parameters after Adam, the
normalizer states and the forward rows equal bit for bit in each process
(the same plain kernels on the same shards, every fold in global rank
order, the gradients summed over the devices of every process in global
order); the ring entries, the halo forwards and the overlap-banded
step's loss and gradients equal the in-process group's of the same shape
bit for bit for every global rank (each rank folds the row's partials in
its ring order, as in one process); against JAX's sharded step on
``make_mesh(1, 2)`` (its ``gather`` path, as
tests/test_torch_port_multihost.py's) the loss within rtol 1e-5 and the
parameters after one Adam step within atol 1e-6; the halo forwards against
JAX's halo forward on ``make_mesh(1, graph)`` (Pallas in interpret mode,
the emulator's state reset first, a mismatch retried once after a reset as
tests/test_torch_port_halo.py does) within rtol 1e-4 and atol 2e-5 in
float32 (tests/test_torch_port_halo.py's, from JAX's test_overlap.py:308).
The control must
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
from jax.experimental.pallas import tpu as pltpu

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.parallel import halo as jax_halo
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
# the pods whose rows ring across processes: (processes, local ranks, graph)
# -> the pod's name in the fixture and its shape
RING_PODS = {(2, 1, 2): ("row", (1, 2)), (2, 2, 4): ("wide", (1, 4)), (4, 1, 2): ("grid", (2, 2))}
RING_IDS = [f"P{p}-n{n}-g{g}" for p, n, g in RING_PODS]
HALO_TOL = dict(rtol=1e-4, atol=2e-5)


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
    cases["flag_fused"].update(control=True)

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


@functools.lru_cache(maxsize=None)
def _ring_case():
    """The ring entries' case: JAX's flag state (as ``_cases``' flag) under
    ``agg_vjp: xla`` (the halo forward's ring) and ``fused`` (K7), the
    trajectory, the frames and the noise draw."""
    flag = _cases()["flag_fused"]
    return dict(configs={agg: _flag_config(agg) for agg in ("xla", "fused")}, trajectory=flag["trajectory"],
                frames=flag["frames"], normal=flag["normal"], params=flag["params"],
                normalizers=flag["normalizers"])


def _reset_interpret():
    pltpu.reset_tpu_interpret_mode_state()
    jax.clear_caches()


def _jax_halo(path, graph):
    """JAX's halo forward of frame 0 on ``make_mesh(1, graph)``
    (tests/test_torch_port_halo.py's), its Pallas kernels in interpret
    mode from a reset emulator."""
    agg, ring, overlap = worker.HALO_PATHS[path]
    j = _jax_start()
    jmodel = jax_get_model(_flag_config(agg))
    mesh = jax_sharding.make_mesh(1, graph)
    jst = jax_sharding.shard_topology(jmodel.topology_from_trajectory(j["traj"]), mesh,
                                      overlap_bands=worker.BANDS if overlap else None)
    jframe = {k: jnp.asarray(v[0]) for k, v in j["traj"].items() if k != "cells"}
    jgraph, _, _ = jmodel.make_graph(j["tstate"].model, jst, jframe, False, batched=False)
    _reset_interpret()
    return np.asarray(jax_halo.make_halo_forward(jmodel, mesh, ring=ring, overlap=overlap)(
        j["tstate"].model.params, jgraph))


def _ring_reference(processes, n_local, graph):
    """The ring entries on the in-process group of the pod's shape, a
    logical device a rank (the pod's devices are each process's own: the
    step sums every device's gradients in global order)."""
    shape = RING_PODS[(processes, n_local, graph)][1]
    devices = [torch.device("cpu", i) for i in range(shape[0] * shape[1])]
    return worker.ring_case(_ring_case(), lambda: RankGroup(*shape, devices=devices))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp, name, job, processes=PROCESSES):
    src = os.path.join(tmp, f"{name}.pt")
    torch.save(job, src)
    port = _free_port()
    outs = [os.path.join(tmp, f"{name}{r}.pt") for r in range(processes)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(processes), str(port), src, outs[r]],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(processes)]
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
    """The pods' results (``row``: the ``1 x 2`` cases, ``wide``: the
    ``1 x 4`` one, each with the ring entries; ``grid``: the ring entries
    of the ``2 x 2`` pod of four processes), the in-process references,
    JAX's ``1 x 2`` step and JAX's halo forwards, the references computed
    while the workers run."""
    tmp = str(tmp_path_factory.mktemp("pod_graph"))
    cases, ring = _cases(), _ring_case()
    wide_devices = [["cpu:0", "cpu:1"]] * PROCESSES
    started = [_start(tmp, "row", dict(graph=2, devices=[["cpu"]] * PROCESSES, cases=cases, ring=ring)),
               _start(tmp, "wide", dict(graph=4, devices=wide_devices, cases={"flag_fused": cases["flag_fused"]},
                                        ring=ring)),
               _start(tmp, "grid", dict(graph=2, devices=[["cpu"]] * 4, ring=ring), processes=4)]
    try:
        refs = {name: worker.run_case(dict(case, control=False), lambda: RankGroup(1, 2, device="cpu"))
                for name, case in cases.items()}
        wide_ref = worker.run_case(dict(cases["flag_fused"], control=False),
                                   lambda: RankGroup(1, 4, devices=[torch.device("cpu", i) for i in range(4)]))
        ring_refs = {layout: _ring_reference(*layout) for layout in RING_PODS}
        jax_ref = _jax_row_step()
        jax_halo = {(path, g): _jax_halo(path, g) for path in worker.HALO_PATHS for g in (2, 4)}
    finally:
        row, wide, grid = (_join(*s) for s in started)
    return dict(row=row, wide=wide, grid=grid, refs=refs, wide_ref=wide_ref, ring_refs=ring_refs, jax=jax_ref,
                jax_halo=jax_halo)


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


def test_ring_kernels_on_a_row_across_processes_raise(pods, monkeypatch):
    """The ring kernels' four entries on the ``1 x 2`` row across processes
    (K7's layout, the halo forward's ring, the ring aggregate and K6) run
    and give the in-process ``RankGroup(1, 2)``'s bits for each global
    rank; on the card a row whose processes run on two nodes raises
    ``NotImplementedError`` naming ROADMAP entry 7.4d (the host names of
    such a pod planted), one on one node does not."""
    want = pods["ring_refs"][(2, 1, 2)]
    for p, res in enumerate(pods["row"]):
        got = res["ring"]
        assert got["layout"]["ranks"] == [p]
        for name in ("senders", "receivers", "mask"):
            assert torch.equal(got["layout"][name], want["layout"][name]), name
        assert all(torch.equal(a, b) for a, b in zip(got["layout"]["work"][p], want["layout"]["work"][p]))
        for entry in ("halo_ring", "aggregate", "k6"):
            assert torch.equal(got[entry][p], want[entry][p]), (entry, p)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    group = multihost.make_pod_group(graph_per_host=2, devices=[torch.device("cpu")])
    assert group.rows_cross and group.ranks == [0]
    group.is_cuda, group._hosts = True, ["node-a", "node-b"]
    with pytest.raises(NotImplementedError, match="7.4d"):
        group.check_ring("the ring all-reduce (K6)")
    group._hosts = ["node-a", "node-a"]
    group.check_ring("the ring all-reduce (K6)")


def _ring_results(pods, layout):
    """Each process's ring results of the pod of ``layout``, and the
    in-process reference."""
    return pods[RING_PODS[layout][0]], pods["ring_refs"][layout]


@pytest.mark.parametrize("layout", list(RING_PODS), ids=RING_IDS)
def test_k6_plain_across_processes_is_bit_for_bit(pods, layout):
    """K6's plain version on seeded partials (sum, max, min and a one-row
    sum segment) and the pna ring aggregate: every global rank's result
    equals the in-process group's bit for bit."""
    results, want = _ring_results(pods, layout)
    seen = set()
    for res in results:
        got = res["ring"]
        assert (got["layout"]["shape"]["data"], got["layout"]["shape"]["graph"]) == RING_PODS[layout][1]
        for q in got["layout"]["ranks"]:
            seen.add(q)
            assert torch.equal(got["k6"][q], want["k6"][q]), q
            assert torch.equal(got["aggregate"][q], want["aggregate"][q]), q
    assert seen == set(want["k6"])


@pytest.mark.parametrize("path", list(worker.HALO_PATHS))
@pytest.mark.parametrize("layout", list(RING_PODS), ids=RING_IDS)
def test_halo_forward_across_processes_matches_jax_and_the_in_process_group(pods, layout, path):
    """The halo forward with ``ring`` (K6) or ``overlap`` (K7 on the
    4-band layout) across processes: every rank's rows bit for bit with the
    in-process group's, and within HALO_TOL of JAX's halo forward on
    ``make_mesh(1, graph)``."""
    results, want = _ring_results(pods, layout)
    for res in results:
        for q, rows in res["ring"][path].items():
            assert torch.equal(rows, want[path][q]), q
    graph = layout[2]
    got = want[path][0].numpy()
    assert got.shape == (NX * NX, 3) and np.isfinite(got).all()
    try:
        np.testing.assert_allclose(got, pods["jax_halo"][(path, graph)], **HALO_TOL)
    except AssertionError:  # the emulator's remote copies can race under load: once more from a reset
        np.testing.assert_allclose(got, _jax_halo(path, graph), **HALO_TOL)


@pytest.mark.parametrize("layout", list(RING_PODS), ids=RING_IDS)
def test_overlap_banded_step_across_processes_is_bit_for_bit(pods, layout):
    """One train step on the overlap-banded layout (K7 forward, K2 per
    shard, the cotangents gathered across processes): the loss and every
    gradient equal the in-process group's bit for bit in each process."""
    results, want = _ring_results(pods, layout)
    for p, res in enumerate(results):
        got = res["ring"]["step"]
        assert torch.equal(got["loss"], want["step"]["loss"]), p
        for n, w in want["step"]["grads"].items():
            assert torch.equal(got["grads"][n], w), (p, n)
