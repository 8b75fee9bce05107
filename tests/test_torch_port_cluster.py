"""k-means, the Gaussian mixture and HDBSCAN in the port against the JAX
package: labels, sampled members and neighbours node for node, the static
of HGN plate's obstacle exclusion, and the hierarchical network and its
train step with each clustering, HDBSCAN's variable cluster count included.

The JAX package clusters with scikit-learn (``get_clustering_algorithm(...)
.run``); the port with ``rmp.sk_numpy``'s copies of its steps and
``rmp.hdbscan_tree``.  Inputs are made with numpy (the synthetic flag and
plate, seeded) and go through both packages.

Sizes and cases:

- labels: the 40x40 flag (1,600 nodes) at frame 0 (flat: the world stream's
  z is 0 everywhere) and frame 5; k-means at K = 10 and 16, the Gaussian
  mixture at 16, HDBSCAN with ``configs/flag_full_scale.yaml``'s block
  (K = 10 with 1,232 noise nodes at frame 0, K = 40 at frame 5), HDBSCAN
  and k-means with intra-cluster sampling; the 5x6 plate with its stamp
  left out, each algorithm; the same labels in an interpreter where
  ``import sklearn`` fails.  A probe found the second-closest centre of
  k-means at K = 16 on the 40x40 grid 3.4e-6 from the closest in float32:
  the port keeps scikit-learn's float32 and its order of operations (the
  same BLAS call for the distances), and no label of the flag moves.
  scikit-learn runs on one OpenMP thread here (``threadpool_limits``): it
  sums each init's inertia in threads, and on the 5x6 plate (a symmetric
  grid) k-means at K = 4 has inits whose clusterings are mirror images of
  each other, at the same inertia up to float32 rounding (14.357144 on one
  thread, 14.357141 on two or more).  Which one wins the best of 10 then
  follows the threads' summation order: scikit-learn 1.9 itself labels 18
  nodes otherwise on 4 threads than on 1 or 2, and all 30 on 8.  The port
  sums on one thread and gives its labels;
- the network: a 10x10 flag, latent 32, 2 blocks, float32, 4 frames;
  HDBSCAN with ``min_cluster_size`` 5 and ``max_cluster_size`` 30 gives
  K = 10 (padded to Kp = 16) with 2 noise nodes at frame 0 and K = Kp = 8
  with 5 noise nodes at frame 2, so one expansion reclustered at frame 0,
  then frame 2, changes Kp between calls.  The JAX reference is its
  ``gather`` path; the port runs ``agg_vjp: fused`` (K1 and K2's plain
  versions over N + Kp rows).

Tolerances are tests/test_torch_port_rmp.py's: labels, members, neighbours
and static arrays equal; network outputs rtol 1e-4, atol 1e-5 of the
largest magnitude; loss rtol 1e-5; gradients rtol 1e-4, atol 1e-4 of each
parameter's largest; normalizer states rtol 1e-5, atol 1e-6 of their
largest; the 2 x 2 sharded step against the single-device step within the
same limits (its gradients sum the ranks' partials in another order: on
HDBSCAN's frame-2 static they read up to 4.4e-5 relative L2 from the
single-device ones, past tests/test_torch_port_spmd_expansion.py's atol
of 1e-5 of the largest element on one tensor).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import jax
from threadpoolctl import threadpool_limits
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.data.synthetic import plate_trajectory as jax_plate_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.rmp import clustering as jax_clustering
from hyper_graph_nets_tpu.rmp.remote_message_passing import _pad_gather_cols as jax_pad_gather_cols
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import make_spmd_train_step, shard_topology
from hyper_graph_nets_tpu_torch.rmp import clustering
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import Trainer, batched_forward
from hyper_graph_nets_tpu_torch.utils.config import read_yaml
from torch_port_cases import flag_config
from torch_port_models import cut_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
HDBSCAN_BLOCK = read_yaml("flag_full_scale")["params"]["model"]["rmp"]["hdbscan"]
SAMPLING = {"enabled": True, "alpha": 0.1, "spotter_threshold": 0}
LABEL_CASES = {
    "kmeans-10": ("kmeans", {"num_clusters": 10}),
    "k-means-16": ("k-means", {"num_clusters": 16}),
    "gmm-16": ("gmm", {"num_clusters": 16}),
    "hdbscan": ("hdbscan", {"hdbscan": HDBSCAN_BLOCK}),
    "hdbscan-sampled": ("hdbscan", {"hdbscan": HDBSCAN_BLOCK, "intra_cluster_sampling": SAMPLING}),
    "kmeans-16-sampled": ("kmeans", {"num_clusters": 16, "intra_cluster_sampling": SAMPLING}),
}
# the network's HDBSCAN: K = 10 (Kp 16) at frame 0, K = Kp = 8 at frame 2
NET_HDBSCAN = {"min_cluster_size": 5, "max_cluster_size": 30, "min_samples": 1}
NX, B, STEP_KEY = 10, 4, 11


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


def _assert_clusterings_equal(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.num_clusters == want.num_clusters
    assert got.neighbors == want.neighbors
    assert len(got.clusters) == len(want.clusters)
    for a, b in zip(got.clusters, want.clusters):
        np.testing.assert_array_equal(a, b)


# -- labels ------------------------------------------------------------------------


def _jax_run(name, cfg, host):
    """The JAX package's clustering, scikit-learn on one OpenMP thread."""
    with threadpool_limits(1, "openmp"):
        return jax_clustering.get_clustering_algorithm(name, cfg).run(host)


@functools.lru_cache(maxsize=None)
def _flag40():
    return jax_add_targets(jax_flag_trajectory(num_steps=8, nx=40, ny=40), "world_pos", True)


@functools.lru_cache(maxsize=None)
def _hosts40(frame):
    config = read_yaml("flag_full_scale")
    traj = _flag40()
    fr = {k: v[frame] for k, v in traj.items()}
    jmodel, model = jax_get_model(config), get_model(config)
    return (jmodel.host_graph(fr, jmodel.topology_from_trajectory(traj)),
            model.host_graph(fr, model.topology_from_trajectory(traj, device="cpu")))


@pytest.mark.parametrize("frame", [0, 5])
@pytest.mark.parametrize("case", list(LABEL_CASES))
def test_labels_equal_jax_on_the_40x40_flag(case, frame):
    """Labels, the cluster count, neighbours and (sampled) member lists."""
    name, cfg = LABEL_CASES[case]
    jhost, host = _hosts40(frame)
    want = _jax_run(name, cfg, jhost)
    got = clustering.get_clustering_algorithm(name, cfg).run(host)
    _assert_clusterings_equal(got, want)
    if name == "hdbscan":
        assert (got.labels < 0).any()  # noise nodes, label -1


def test_labels_need_no_sklearn():
    """The port's three clusterings in a fresh interpreter where ``import
    sklearn`` fails: the same labels as the JAX package's."""
    jhost, _ = _hosts40(5)
    names = ("kmeans", "gmm", "hdbscan")
    want = [_jax_run(n, LABEL_CASES[c][1], jhost).labels for n, c in zip(names, ("k-means-16", "gmm-16", "hdbscan"))]
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets\n"
        "from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory\n"
        "from hyper_graph_nets_tpu_torch.models.get_model import get_model\n"
        "from hyper_graph_nets_tpu_torch.rmp.clustering import get_clustering_algorithm\n"
        "from hyper_graph_nets_tpu_torch.utils.config import read_yaml\n"
        "config = read_yaml('flag_full_scale')\n"
        "model = get_model(config)\n"
        "traj = add_targets(flag_trajectory(num_steps=8, nx=40, ny=40), 'world_pos', True)\n"
        "host = model.host_graph({k: v[5] for k, v in traj.items()},\n"
        "                        model.topology_from_trajectory(traj, device='cpu'))\n"
        "hb = config['params']['model']['rmp']['hdbscan']\n"
        "for name, cfg in (('kmeans', {'num_clusters': 16}), ('gmm', {'num_clusters': 16}),\n"
        "                  ('hdbscan', {'hdbscan': hb})):\n"
        "    print(' '.join(map(str, get_clustering_algorithm(name, cfg).run(host).labels)))\n"
        "bad = [m for m, mod in sys.modules.items()\n"
        "       if mod is not None and m.split('.')[0] in ('sklearn', 'jax', 'hyper_graph_nets_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3
    for line, w, name in zip(lines, want, names):
        np.testing.assert_array_equal(np.asarray(line.split(), int), w, err_msg=name)


@functools.lru_cache(maxsize=None)
def _plate():
    return jax_add_targets(jax_plate_trajectory(num_steps=3, nx=5, ny=6, seed=0), "world_pos", False)


@pytest.mark.parametrize("name", ["kmeans", "gmm", "hdbscan"])
def test_hgn_plate_leaves_the_stamp_out_as_jax_does(name):
    """configs/plateCluster.yaml with the clustering swapped (K = 4 for
    k-means and the mixture; HDBSCAN at min_cluster_size 3, max 10, which
    finds 4 clusters and 4 noise nodes among the plate's 30): the stamp's
    nodes get label -1, and the labels, members and every static array equal
    the JAX package's."""
    rmp = {"clustering": name, "num_clusters": 4,
           "hdbscan": {"min_cluster_size": 3, "max_cluster_size": 10, "min_samples": 1}}
    config = cut_config("plateCluster", "gather")
    config["params"]["model"]["rmp"].update(rmp)
    traj = _plate()
    frame = {k: v[0] for k, v in traj.items()}
    jmodel, model = jax_get_model(config), get_model(config)
    jexp, exp = jax_build_expansion(jmodel, config), build_expansion(model, config)
    with threadpool_limits(1, "openmp"):
        jstatic = jexp.prepare(jmodel, frame, jmodel.topology_from_trajectory(traj))[-1]
    static = exp.prepare(model, frame, model.topology_from_trajectory(traj, device="cpu"))[-1]
    want, got = jexp.members[-1]._last_clustering, exp.members[-1]._last_clustering
    _assert_clusterings_equal(got, want)
    stamp = np.asarray(frame["node_type"])[:, 0] == 1
    assert stamp.any() and (got.labels[stamp] == -1).all() and got.num_clusters == 4
    if name == "hdbscan":  # 4 of the plate's own nodes are noise too
        assert int((got.labels[~stamp] < 0).sum()) == 4
    for f in jstatic._fields:
        b = getattr(jstatic, f)
        if f.endswith("_plan") or b is None:
            continue
        a = getattr(static, f)
        for x, y in zip(a if isinstance(b, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(x.cpu() if torch.is_tensor(x) else x), np.asarray(y),
                                          err_msg=f)


# -- the network and its train step ---------------------------------------------------


def _config(name, agg_vjp="fused"):
    config = flag_config(None, agg_vjp=agg_vjp)
    model = config["params"]["model"]
    model.update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    model["rmp"] = {"clustering": name, "connector": "hyper", "num_clusters": 5, "hyper_noise": 0.005,
                    "hyper_node_features": True, "frequency": 1, "hdbscan": NET_HDBSCAN}
    return config


@functools.lru_cache(maxsize=None)
def _traj():
    return jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)


def _frame(i):
    return {k: v[i] for k, v in _traj().items()}


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    return params, {name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
                    for name, ns in state.normalizers.items()}


@functools.lru_cache(maxsize=None)
def _jax_net():
    """JAX's ``gather`` model, expansion and topology; one state whose
    normalizers have seen the trajectory (expanded with HDBSCAN's frame-0
    static), shared by every case; and one jitted function of the static
    (an argument, so statics of one shape share a compile): the forward of
    the first B frames, and the train step's loss, gradients and normalizers
    with its own noise draws at ``STEP_KEY``."""
    config = _config("hdbscan", "gather")
    model = jax_get_model(config)
    traj = _traj()
    topo = model.topology_from_trajectory(traj)
    exp = jax_build_expansion(model, config)
    every = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    frames = {k: jnp.asarray(v[:B]) for k, v in traj.items() if k != "cells"}
    _, nkey, ekey = jax.random.split(jax.random.PRNGKey(STEP_KEY), 3)
    noisy = jax_add_noise(frames, model.field, model.noise_scale, model.noise_gamma, nkey)

    @jax.jit
    def accumulate(state, static):
        graph, _, state = model.make_graph(state, topo, every, True)
        _, state = exp.expand(state, graph, every, model, True, key=jax.random.PRNGKey(3), static=static)
        return model.get_target(state, every, True)[1]

    def loss_fn(params, normalizers, static):
        mstate = JModelState(params=params, normalizers=normalizers)
        g, _, mstate = model.make_graph(mstate, topo, noisy, True)
        g, mstate = exp.expand(mstate, g, noisy, model, is_training=True, key=ekey, static=static)
        target, mstate = model.get_target(mstate, noisy, is_training=True)
        out = jax_batched_forward(model, mstate.params, g)
        mask = model.loss_mask(noisy["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    @jax.jit
    def step(state, static):
        graph, _, s = model.make_graph(state, topo, frames, False)
        graph, _ = exp.expand(s, graph, frames, model, False, static=static)
        forward = jax_batched_forward(model, state.params, graph)
        return forward, jax.value_and_grad(loss_fn, has_aux=True)(state.params, state.normalizers, static)

    with threadpool_limits(1, "openmp"):
        static0 = exp.prepare(model, _frame(0), topo)
    state = accumulate(jax.jit(model.init_state)(jax.random.PRNGKey(0)), static0)
    D = traj["world_pos"].shape[-1] + traj["mesh_pos"].shape[-1]
    return state, step, nkey, ekey, noisy["world_pos"].shape, D


@functools.lru_cache(maxsize=None)
def _jax_side(name, frame):
    """The JAX package clustering ``frame`` with ``name`` (its own
    expansion), and its forward, loss, gradients (in the port's layout),
    normalizers and noise draws on that static."""
    config = _config(name, "gather")
    model = jax_get_model(config)
    exp = jax_build_expansion(model, config)
    with threadpool_limits(1, "openmp"):
        static = exp.prepare(model, _frame(frame), model.topology_from_trajectory(_traj()))
    # wider inert columns (valid 0) in the inter set's neighbour matrix, as
    # the JAX package's own padding adds, so that every static with Kp = 8
    # shares one compile of ``step``
    rmp_static = static[-1]
    static = static[:-1] + (rmp_static._replace(inter_gather=jax_pad_gather_cols(rmp_static.inter_gather, 4)),)
    state, step, nkey, ekey, field_shape, D = _jax_net()
    forward, ((loss, norms), grads) = step(state, static)
    _, sub = jax.random.split(ekey)
    Kp = static[-1].assign_mean.shape[0]
    return dict(
        numpy_state=_numpy_state(state), forward=np.asarray(forward), loss=float(loss), norms=norms,
        K=exp.members[-1]._last_clustering.num_clusters, Kp=Kp,
        grads={n: g.detach() for n, g in state_from_jax_numpy(jax.tree.map(np.asarray, grads), {})
               .params.named_parameters()},
        normal=torch.from_numpy(np.array(jax.random.normal(nkey, field_shape, jnp.float32))),
        hyper=torch.from_numpy(np.array(jax.random.normal(sub, (B, Kp, D), jnp.float32))),
    )


def _assert_grads_close(params, want, atol=1e-4, what=""):
    for name, p in params.named_parameters():
        w = want[name]
        torch.testing.assert_close(p.grad, w, rtol=1e-4, atol=atol * max(float(w.abs().max()), 1e-12),
                                   msg=f"{what}{name}")


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(getattr(got[name], f).detach().numpy(), w, rtol=1e-5,
                                       atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=f"{name}.{f}")


def _port_step(trainer, model, topo, static, j):
    """The port's forward and loss/gradients on JAX's state and draws."""
    tstate = trainer.init_train_state(state=state_from_jax_numpy(*j["numpy_state"]))
    frames = trainer.frames({k: v[:B] for k, v in _traj().items()})
    with torch.no_grad():
        graph, _, s = model.make_graph(tstate.model, topo, frames, False)
        graph, _ = trainer.expansion.expand(s, graph, frames, model, False, static=static)
        out = batched_forward(model, tstate.model.params, graph).numpy()
    plan = graph.edge_sets["mesh_edges"].plan
    assert isinstance(plan, SegmentPlan) and plan.num_nodes == graph.num_nodes + graph.num_hyper_nodes
    loss, norms = trainer.loss_and_grads(tstate, topo, frames, normal=j["normal"], static=static,
                                         hyper_normal=j["hyper"])
    return out, float(loss), tstate.model.params, norms


# (algorithm, frames it reclusters): k-means and the mixture at K = 6
# (padded to 8) on frame 0; HDBSCAN on frame 0 (K 10, Kp 16), then frame 2
# (K = Kp = 8)
NET_CASES = {"kmeans": (0,), "gmm": (0,), "hdbscan": (0, 2)}


@pytest.mark.parametrize("name", list(NET_CASES))
def test_network_and_train_step_equal_jax(name):
    """The forward and the float32 train step against JAX's after each
    recluster of one expansion; HDBSCAN's cluster count changes between its
    two, Kp from 16 to 8, and its noise nodes hang from no cluster; the
    mesh set's plan spans N + Kp rows after each."""
    model = get_model(_config(name))
    trainer = Trainer(model, _config(name), device="cpu")
    topo = model.topology_from_trajectory(_traj(), device="cpu")
    rmp = trainer.expansion.members[-1]
    Kps = []
    for frame in NET_CASES[name]:
        rmp.reset_clusters()
        static = trainer.expansion.prepare(model, _frame(frame), topo)
        j = _jax_side(name, frame)
        assert (static[-1].num_clusters, int(static[-1].assign_mean.shape[0])) == (j["Kp"], j["Kp"])
        out, loss, params, norms = _port_step(trainer, model, topo, static, j)
        scale = float(np.abs(j["forward"]).max())
        np.testing.assert_allclose(out, j["forward"], rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(loss, j["loss"], rtol=1e-5)
        _assert_grads_close(params, j["grads"])
        _assert_normalizers_close(norms, j["norms"])
        Kps.append((rmp._last_clustering.num_clusters, j["K"], j["Kp"]))
    if name == "hdbscan":
        assert Kps == [(10, 10, 16), (8, 8, 8)], Kps
        assert (rmp._last_clustering.labels < 0).any()
    else:
        assert Kps == [(5, 5, 8)], Kps


def test_predictor_replans_when_a_recluster_changes_kp():
    """``Predictor.one_step`` and ``rollout`` on HDBSCAN, the trajectory
    starting at frame 0, then at frame 2: each call reclusters its first
    frame (Kp 16, then 8) and gives what a fresh ``Predictor`` gives on that
    trajectory alone (no plan or static of the previous call is reused)."""
    config = _config("hdbscan")
    state = state_from_jax_numpy(*_jax_side("hdbscan", 0)["numpy_state"])
    p = Predictor.from_config(config, device="cpu")
    p.state = state
    for start, Kp in ((0, 16), (2, 8), (0, 16)):
        traj = {k: v[start:] for k, v in _traj().items()}
        fresh = Predictor.from_config(config, device="cpu")
        fresh.state = state
        np.testing.assert_array_equal(p.one_step(traj), fresh.one_step(traj))
        static = p.expansion.members[-1].static
        assert static.num_clusters == Kp and static.mesh_plan.num_nodes == traj["world_pos"].shape[1] + Kp
        np.testing.assert_array_equal(p.rollout(traj, num_steps=2)["pred_pos"],
                                      fresh.rollout(traj, num_steps=2)["pred_pos"])


def test_sharded_hdbscan_step_matches_single_device():
    """The 2 x 2 sharded step (CPU ranks) on HDBSCAN's padded Kp, after a
    recluster that changes Kp (16, then 8): the cluster-tier sets, the
    mesh set's per-rank plans over N + Kp rows and the sliced cluster-mean
    noise follow each static; against the port's single-device step and
    JAX's."""
    model = get_model(_config("hdbscan"))
    trainer = Trainer(model, _config("hdbscan"), device="cpu")
    topo = model.topology_from_trajectory(_traj(), device="cpu")
    group = RankGroup(2, 2, device="cpu")
    step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
    frames = trainer.frames({k: v[:B] for k, v in _traj().items()})
    for frame in (0, 2):
        trainer.expansion.members[-1].reset_clusters()
        static = trainer.expansion.prepare(model, _frame(frame), topo)
        j = _jax_side("hdbscan", frame)
        single = trainer.init_train_state(state=state_from_jax_numpy(*j["numpy_state"]))
        want, _ = trainer.loss_and_grads(single, topo, frames, normal=j["normal"], static=static,
                                         hyper_normal=j["hyper"])
        want_grads = {n: p.grad.clone() for n, p in single.model.params.named_parameters()}
        ts = trainer.init_train_state(state=state_from_jax_numpy(*j["numpy_state"]))
        loss, norms = step.loss_and_grads(ts, frames, normal=j["normal"], static=static, hyper_normal=j["hyper"])
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(loss), j["loss"], rtol=1e-5)
        _assert_grads_close(ts.model.params, want_grads, what=f"frame {frame} port: ")
        _assert_grads_close(ts.model.params, j["grads"], what=f"frame {frame} jax: ")
        _assert_normalizers_close(norms, j["norms"])
