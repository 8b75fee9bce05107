"""Remote message passing in the port against the JAX package: clustering,
the static incidence, the connectors, the hierarchical networks, the train
step's loss and gradients, ``Predictor`` and the two repairs that came with
it (the band criterion on the fused path, the fixed-order sums).

Inputs are made with numpy (the synthetic flag, seeded) and go through both
packages; the port gets the JAX package's state through ``convert``.  Small
sizes: an 8x8 flag (64 nodes), 4 clusters, latent 32, 2 message-passing
blocks; the label tests run on the 40x40 flag with 16 clusters, as shipped.

Tolerances:

- clustering labels, sampled members, static arrays: equal;
- connector features and normalizer states (float32): rtol 1e-5, atol 1e-6
  (the same sums in another order); the hyper features rtol 1e-4, atol
  1e-5: their spreads are standardized by the spread of the spreads, which
  is small and turns a float32 unit in the last place of a cluster mean
  into a few 1e-5 of the feature;
- network outputs in float32: rtol 1e-4, atol 1e-5 of the output's largest
  magnitude (15 products and LayerNorms in another order); in bf16 atol
  0.05 of the largest magnitude: a bf16 rounding (2^-8 relative) that lands
  on the other side in one package flips the last bit of an activation, and
  the cluster means sum 16 such activations before the next rounding;
- loss rtol 1e-5; gradients (float32) atol 1e-4 of each parameter's
  largest gradient, rtol 1e-4.  The port's fused path (K2's plain version)
  routes a tied max/min cotangent in full where the JAX package's fused
  path does too, so both are held against the JAX ``gather`` path, whose
  ``pna_gather`` routes ties the same way (ROADMAP, standing findings).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.rmp import clustering as jax_clustering
from hyper_graph_nets_tpu.rmp.connector import build_static as jax_build_static
from hyper_graph_nets_tpu.rmp.remote_message_passing import RemoteMessagePassing as JaxRMP
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import fused_block
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan
from hyper_graph_nets_tpu_torch.rmp import clustering
from hyper_graph_nets_tpu_torch.rmp.connector import build_static
from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import RemoteMessagePassing
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import Trainer, batched_forward
from hyper_graph_nets_tpu_torch.utils.config import read_yaml
from torch_port_cases import flag_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
NX = 8  # 64 nodes
K = 4


def rmp_config(arch="hyper", dtype=None, agg_vjp="fused", clustering_name="spectral", **model):
    config = flag_config(dtype, agg_vjp=agg_vjp)
    config["params"]["model"]["rmp"] = {
        "clustering": clustering_name, "connector": arch, "num_clusters": K,
        "hyper_noise": 0.003, "hyper_node_features": True, "frequency": 1,
    }
    config["params"]["model"].update(model)
    return config


@functools.lru_cache(maxsize=None)
def _trajectory(nx=NX, steps=4):
    return jax_add_targets(jax_flag_trajectory(num_steps=steps, nx=nx, ny=nx), "world_pos", True)


def _frames(traj, n=2):
    return {k: np.asarray(v[:n]) for k, v in traj.items() if k != "cells"}


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


@functools.lru_cache(maxsize=None)
def _jax_state(arch="hyper", dtype=None, agg_vjp="gather", balancer=False):
    """A JAX init whose normalizers (the RMP ones included) have seen the
    trajectory in training mode, and its numpy form."""
    config = rmp_config(arch, dtype, agg_vjp, **_balancer(balancer))
    model = jax_get_model(config)
    traj = _trajectory()
    exp = jax_build_expansion(model, config)
    topo = model.topology_from_trajectory(traj)
    static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    state = model.init_state(jax.random.PRNGKey(0))
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    graph, _, state = model.make_graph(state, topo, frames, True)
    _, state = exp.expand(state, graph, frames, model, True, key=jax.random.PRNGKey(3), static=static)
    state = model.get_target(state, frames, True)[1]
    return state, _numpy_state(state)


def _balancer(on):
    if not on:
        return {}
    return {"graph_balancer": {"algorithm": "random", "remove_edges": True, "frequency": 1,
                               "random": {"edge_amount": 10}}}


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(
                getattr(got[name], f).detach().numpy(), w, rtol=1e-5,
                atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=f"{name}.{f}",
            )


# -- clustering -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _host_graphs(nx=40):
    config = read_yaml("flag_full_scale")
    traj = _trajectory(nx, steps=3)
    frame = {k: v[0] for k, v in traj.items()}
    jmodel, model = jax_get_model(config), get_model(config)
    jhost = jmodel.host_graph(frame, jmodel.topology_from_trajectory(traj))
    host = model.host_graph(frame, model.topology_from_trajectory(traj))
    return jhost, host


def test_host_graph_matches_jax():
    jhost, host = _host_graphs()
    for f in clustering.HostGraph._fields:
        a, b = getattr(host, f), getattr(jhost, f)
        if a is None or isinstance(a, int):
            assert a == b, f
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=f)


def test_spectral_labels_equal_jax_on_the_40x40_flag():
    """16 clusters, as configs/flag_full_scale.yaml ships: every label equal
    (a relabelled cluster would reorder the hyper rows)."""
    jhost, host = _host_graphs()
    want = jax_clustering.SpectralClustering(16).run(jhost)
    got = clustering.SpectralClustering(16).run(host)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.neighbors == want.neighbors
    for a, b in zip(got.clusters, want.clusters):
        np.testing.assert_array_equal(a, b)


def test_spectral_needs_no_sklearn():
    """The port's spectral clustering in a fresh interpreter where
    ``import sklearn`` fails: the same labels as the JAX package's."""
    jhost, _ = _host_graphs()
    want = jax_clustering.SpectralClustering(16).run(jhost).labels
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets\n"
        "from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory\n"
        "from hyper_graph_nets_tpu_torch.models.get_model import get_model\n"
        "from hyper_graph_nets_tpu_torch.rmp.clustering import SpectralClustering\n"
        "from hyper_graph_nets_tpu_torch.utils.config import read_yaml\n"
        "model = get_model(read_yaml('flag_full_scale'))\n"
        "traj = add_targets(flag_trajectory(num_steps=3, nx=40, ny=40), 'world_pos', True)\n"
        "host = model.host_graph({k: v[0] for k, v in traj.items()}, model.topology_from_trajectory(traj))\n"
        "labels = SpectralClustering(16).run(host).labels\n"
        "bad = [m for m, mod in sys.modules.items()\n"
        "       if mod is not None and m.split('.')[0] in ('sklearn', 'jax', 'hyper_graph_nets_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(map(str, labels)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.asarray(out.stdout.split(), int), want)


def _small_host(nx=NX):
    config = rmp_config()
    traj = _trajectory(nx)
    frame = {k: v[0] for k, v in traj.items()}
    jmodel, model = jax_get_model(config), get_model(config)
    jhost = jmodel.host_graph(frame, jmodel.topology_from_trajectory(traj))
    return jhost, model.host_graph(frame, model.topology_from_trajectory(traj))


@pytest.mark.parametrize(
    "name, sampling",
    [("random", False), ("random", True), ("spectral", True)],
    ids=["random", "random-sampled", "spectral-sampled"],
)
def test_clustering_and_sampling_equal_jax(name, sampling):
    """Labels, neighbours and (sampled) member lists, three reclusters in a
    row on one algorithm object (its random streams run on)."""
    jhost, host = _small_host()
    cfg = {"num_clusters": K, "intra_cluster_sampling": {"enabled": sampling, "alpha": 0.3,
                                                         "spotter_threshold": 1}}
    jalg = jax_clustering.get_clustering_algorithm(name, cfg)
    alg = clustering.get_clustering_algorithm(name, cfg)
    for _ in range(3):
        want, got = jalg.run(jhost), alg.run(host)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.neighbors == want.neighbors
        assert len(got.clusters) == len(want.clusters)
        for a, b in zip(got.clusters, want.clusters):
            np.testing.assert_array_equal(a, b)


def _static_pair(num_clusters, **kwargs):
    jhost, host = _small_host()
    cfg = {"num_clusters": num_clusters}
    jc = jax_clustering.get_clustering_algorithm("random", cfg).run(jhost)
    c = clustering.get_clustering_algorithm("random", cfg).run(host)
    centers = None
    if kwargs.get("inter_mode") == "delaunay":
        centers = np.stack([host.mesh_features[m].mean(axis=0) for m in c.clusters])
    n = host.target_feature.shape[0]
    return (jax_build_static(jc, n, cluster_centers=centers, **kwargs),
            build_static(c, n, cluster_centers=centers, **kwargs))


@pytest.mark.parametrize(
    "num_clusters, kwargs",
    [(4, {}), (5, {}), (3, {}), (5, {"fully_connect": True}), (6, {"inter_mode": "delaunay"})],
    ids=["K4", "K5-padded", "K3-full", "K5-fully-connected", "K6-delaunay"],
)
def test_build_static_and_padding_equal_jax(num_clusters, kwargs):
    jstatic, static = _static_pair(num_clusters, **kwargs)
    for padded in (False, True):
        if padded:
            jstatic, static = JaxRMP._pad_static(jstatic), RemoteMessagePassing._pad_static(static)
        for f in jstatic._fields:
            if f.endswith("_plan"):  # the JAX package's band plans, None here
                assert getattr(jstatic, f) is None, f
                continue
            a, b = getattr(static, f), getattr(jstatic, f)
            if b is None:
                assert a is None, f
                continue
            if isinstance(b, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


# -- the connector ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hyper", "multi"])
@pytest.mark.parametrize("is_training", [False, True])
def test_connector_expand_equals_jax(arch, is_training):
    """Hyper features, every edge set's features, senders, receivers, masks
    and neighbour matrices, and the new normalizer states; in training with
    the JAX package's noise draw on the cluster means."""
    config = rmp_config(arch, agg_vjp="gather")
    traj = _trajectory()
    jmodel, model = jax_get_model(config), get_model(config)
    jexp, exp = jax_build_expansion(jmodel, config), build_expansion(model, config)
    jtopo, topo = jmodel.topology_from_trajectory(traj), model.topology_from_trajectory(traj)
    frame0 = {k: v[0] for k, v in traj.items()}
    jstatic, static = jexp.prepare(jmodel, frame0, jtopo), exp.prepare(model, frame0, topo)
    jstate, nstate = _jax_state(arch)
    jframes = {k: jnp.asarray(v) for k, v in _frames(traj).items()}
    frames = {k: torch.tensor(np.asarray(v)) for k, v in jframes.items()}
    key = jax.random.PRNGKey(7)
    _, sub = jax.random.split(key)
    Kp = static[0].num_clusters
    normal = np.array(jax.random.normal(sub, (2, Kp, 5), jnp.float32))
    jgraph, _, js = jmodel.make_graph(jstate, jtopo, jframes, is_training)
    jgraph, js = jexp.expand(js, jgraph, jframes, jmodel, is_training, key=key, static=jstatic)
    state = state_from_jax_numpy(*nstate)
    graph, _, s = model.make_graph(state, topo, frames, is_training)
    graph, s = exp.expand(s, graph, frames, model, is_training, static=static,
                          hyper_normal=torch.from_numpy(normal))
    np.testing.assert_allclose(graph.hyper_features.numpy(), np.asarray(jgraph.hyper_features),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(graph.node_features.numpy(), np.asarray(jgraph.node_features),
                               rtol=1e-5, atol=1e-6)
    assert set(graph.edge_sets) == set(jgraph.edge_sets)
    for name, jes in jgraph.edge_sets.items():
        es = graph.edge_sets[name]
        np.testing.assert_allclose(es.features.numpy(), np.asarray(jes.features), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert (es.mask is None) == (jes.mask is None), name
        if es.mask is not None:
            np.testing.assert_array_equal(es.mask.expand(es.features.shape[:-1]).numpy(),
                                          np.asarray(jes.mask), err_msg=name)
        for f in ("senders", "receivers", "gather_idx", "gather_valid", "snd_gather_idx",
                  "snd_gather_valid"):
            a, b = getattr(es, f), getattr(jes, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{f}")
        assert es.sums is not None and es.sums.receivers.num_segments >= graph.num_nodes
    _assert_normalizers_close(s.normalizers, js.normalizers)


# -- the network -----------------------------------------------------------------


def _port_net(config, nstate, traj, frames_np):
    model = get_model(config)
    exp = build_expansion(model, config)
    topo = model.topology_from_trajectory(traj)
    state = state_from_jax_numpy(*nstate)
    frames = {k: torch.tensor(v) for k, v in frames_np.items()}
    with torch.no_grad():
        graph, _, s = model.make_graph(state, topo, frames, False)
        if exp is not None:
            static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
            graph, s = exp.expand(s, graph, frames, model, False, static=static)
        return batched_forward(model, state.params, graph).numpy(), graph


def _jax_net(config, jstate, traj, frames_np):
    model = jax_get_model(config)
    exp = jax_build_expansion(model, config)
    topo = model.topology_from_trajectory(traj)
    frames = {k: jnp.asarray(v) for k, v in frames_np.items()}
    graph, _, s = model.make_graph(jstate, topo, frames, False)
    if exp is not None:
        static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        graph, s = exp.expand(s, graph, frames, model, False, static=static)
    return np.asarray(jax_batched_forward(model, jstate.params, graph))


NETWORK_CASES = [
    ("hyper", None, "fused"), ("hyper", "bfloat16", "fused"), ("hyper", None, "sorted"),
    ("hyper", None, "gather"), ("multiscale", None, "fused"), ("multiscale", "bfloat16", "fused"),
    ("hetero", None, "fused"), ("multi", None, "fused"), ("repeated", None, "fused"),
]


@pytest.mark.parametrize("arch, dtype, agg_vjp", NETWORK_CASES, ids=["-".join(map(str, c)) for c in NETWORK_CASES])
def test_network_forward_equals_jax(arch, dtype, agg_vjp):
    """Network outputs on the expanded graph (``repeated`` is the flat block
    twice, without RMP).  The JAX side runs its Pallas kernels in interpret
    mode; the port on the CPU runs their plain versions."""
    config = rmp_config(arch, dtype, agg_vjp)
    if arch == "repeated":
        config["params"]["model"]["rmp"].update(clustering="none", connector="repeated")
    traj = _trajectory()
    jstate, nstate = _jax_state("hyper" if arch == "repeated" else arch, dtype, "gather")
    if arch == "repeated":
        jstate = jstate.replace(params=jax_get_model(config).init_state(jax.random.PRNGKey(0)).params)
        nstate = (_numpy_state(jstate)[0], nstate[1])
    frames = _frames(traj)
    want = _jax_net(config, jstate, traj, frames)
    got, graph = _port_net(config, nstate, traj, frames)
    scale = float(np.abs(want).max())
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)
    if arch in ("hyper", "multiscale") and agg_vjp == "fused":
        # the mesh set runs the fused path over all N + K rows
        plan = graph.edge_sets["mesh_edges"].plan
        assert isinstance(plan, SegmentPlan) and plan.num_nodes == graph.num_nodes + graph.num_hyper_nodes


# -- the train step --------------------------------------------------------------


def _jax_loss_and_grads(model, jstate, topo, frames_np, step_key, exp=None, static=None):
    """``make_train_step``'s loss_fn with JAX's own noise draws from
    ``step_key`` (``trainer.py:159``), and its gradients."""
    _, nkey, ekey = jax.random.split(step_key, 3)
    frames = {k: jnp.asarray(v) for k, v in frames_np.items()}
    frames = jax_add_noise(frames, model.field, model.noise_scale, model.noise_gamma, nkey)

    def loss_fn(params, normalizers):
        mstate = JModelState(params=params, normalizers=normalizers)
        graph, _, mstate = model.make_graph(mstate, topo, frames, True)
        if exp is not None:
            graph, mstate = exp.expand(mstate, graph, frames, model, is_training=True, key=ekey, static=static)
        target, mstate = model.get_target(mstate, frames, is_training=True)
        out = jax_batched_forward(model, mstate.params, graph)
        mask = model.loss_mask(frames["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, normalizers), grads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params, jstate.normalizers)
    return float(loss), state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params, normalizers


def jax_draws(step_key, field_shape, hyper_shape, members=1):
    """The standard-normal draws of JAX's train step at ``step_key``: the
    field's (``nkey``) and RMP's, the last of ``members`` expansion members
    (each splits the expansion key once, ``expansion.py:78-84``)."""
    _, nkey, ekey = jax.random.split(step_key, 3)
    for _ in range(members):
        ekey, sub = jax.random.split(ekey)
    return (torch.from_numpy(np.array(jax.random.normal(nkey, field_shape, jnp.float32))),
            torch.from_numpy(np.array(jax.random.normal(sub, hyper_shape, jnp.float32))))


def _assert_grads_close(params, want, l2_prefix=None, l2_tol=0.0):
    """Elementwise (rtol 1e-4, atol 1e-4 of the tensor's largest gradient);
    parameters named ``l2_prefix...`` by relative L2 norm within ``l2_tol``.
    A parameter that gets no gradient in the port (None: ``hetero``'s last
    ``hyper_node_model_cross``, whose output nothing reads) must get zeros
    in JAX."""
    wparams = dict(want.named_parameters())
    for name, p in params.named_parameters():
        w = wparams[name].detach().numpy()
        if p.grad is None:
            assert not np.any(w), name
            continue
        if l2_prefix is not None and name.startswith(l2_prefix):
            rel = np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w)
            assert rel <= l2_tol, (name, rel)
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * max(scale, 1e-12),
                                   err_msg=name)


@pytest.mark.parametrize(
    "balancer, arch, agg_vjp, bwd",
    [
        (False, "hyper", "fused", "remat"),
        (True, "hyper", "fused", "remat"),
        (False, "hyper", "xla", "remat"),
        (False, "hyper", "sorted", "remat"),
        (False, "hyper", "fused", "stream"),
        (False, "multiscale", "fused", "remat"),
        (False, "multi", "fused", "remat"),
        (False, "hetero", "fused", "remat"),
    ],
    ids=["rmp", "balancer+rmp", "hyper-xla", "hyper-sorted", "hyper-stream", "multiscale", "multi", "hetero"],
)
def test_loss_and_grads_equal_jax(balancer, arch, agg_vjp, bwd):
    """``Trainer.loss_and_grads``, float32, with JAX's field and hyper noise
    draws, against the JAX ``gather`` path's loss, gradients and normalizer
    states: ``hyper`` under ``agg_vjp: fused`` (K1 and K2's plain versions
    on the mesh set; with the random balancer, 10 pairs added and 10
    removed, before RMP the balance set rides along), under ``xla``,
    ``sorted`` and fused with ``fused_bwd: stream`` (K3's plain version),
    and ``multiscale``, ``multi`` and ``hetero`` under fused.  ``hetero``'s
    last ``hyper_node_model_cross`` gets no gradient: None in the port,
    zeros in JAX."""
    config = rmp_config(arch, None, agg_vjp, noise=0.003, gamma=0.9, learning_rate=1e-4, fused_bwd=bwd,
                        **_balancer(balancer))
    traj = _trajectory()
    jstate, nstate = _jax_state(arch, None, "gather", balancer)
    frames_np = _frames(traj)
    step_key = jax.random.PRNGKey(11)
    jconfig = rmp_config(arch, None, "gather", noise=0.003, gamma=0.9, **_balancer(balancer))
    jmodel = jax_get_model(jconfig)
    jexp = jax_build_expansion(jmodel, jconfig)
    jtopo = jmodel.topology_from_trajectory(traj)
    jstatic = jexp.prepare(jmodel, {k: v[0] for k, v in traj.items()}, jtopo)
    want_loss, want_grads, want_norms = _jax_loss_and_grads(jmodel, jstate, jtopo, frames_np, step_key,
                                                            jexp, jstatic)

    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    tstate = trainer.init_train_state(state=state_from_jax_numpy(*nstate))
    topo = model.topology_from_trajectory(traj)
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    frames = trainer.frames(frames_np)
    shape = trainer.expansion.hyper_noise_shape(model, frames, static)
    normal, hyper = jax_draws(step_key, frames["world_pos"].shape, shape, members=1 + balancer)
    loss, norms = trainer.loss_and_grads(tstate, topo, frames, normal=normal, static=static,
                                         hyper_normal=hyper)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_grads_close(tstate.model.params, want_grads)
    _assert_normalizers_close(norms, want_norms)


# -- Predictor ---------------------------------------------------------------------


def test_predictor_hyper_demo_equals_jax():
    """``Predictor.from_config`` on configs/hyper_demo.yaml cut to latent 32,
    2 blocks, float32 (8 clusters, spectral, fused): ``one_step`` and a
    3-step ``rollout`` (each call reclusters on the first frame) against
    the JAX package's ``Predictor`` with the same state."""
    config = read_yaml("hyper_demo")
    config["params"]["model"].update(latent_size=32, message_passing_steps=2, compute_dtype=None)
    traj = _trajectory()
    jp = JaxPredictor(config)
    jmodel = jp.model
    exp = jax_build_expansion(jmodel, config)
    topo = jmodel.topology_from_trajectory(traj)
    static = exp.prepare(jmodel, {k: v[0] for k, v in traj.items()}, topo)
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    graph, _, state = jmodel.make_graph(jp.state, topo, frames, True)
    _, state = exp.expand(state, graph, frames, jmodel, True, key=jax.random.PRNGKey(1), static=static)
    state = jmodel.get_target(state, frames, True)[1]
    jp.state = state
    p = Predictor.from_config(config, device="cpu")
    p.state = state_from_jax_numpy(*_numpy_state(state))
    np.testing.assert_allclose(p.one_step(traj), jp.one_step(traj), rtol=1e-5, atol=1e-6)
    got, want = p.rollout(traj, num_steps=3), jp.rollout(traj, num_steps=3)
    np.testing.assert_allclose(got["pred_pos"], want["pred_pos"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4, atol=1e-9)
    assert p.expansion.members[0].static.num_clusters == 8


# -- repairs ------------------------------------------------------------------------


def _permuted_tie_case(nx=48):
    """A 48x48 flag (2,304 nodes) with its node ids permuted (seeded), so
    that the JAX fused kernel's band criterion rejects the numbering, and
    ``chip_smoke.tie_topology``'s duplicated edges (every third receiver's
    first edge twice), whose copies tie exactly in every block."""
    from chip_smoke import tie_topology
    from hyper_graph_nets_tpu.core.mesh import cells_to_edges as jax_cells_to_edges

    traj = _trajectory(nx, steps=3)
    n = traj["world_pos"].shape[1]
    perm = np.random.RandomState(0).permutation(n)
    inv = np.argsort(perm)
    out = {}
    for k, v in traj.items():
        if k == "cells":
            out[k] = inv[v].astype(v.dtype)
        elif v.ndim >= 2 and v.shape[1] == n:
            out[k] = v[:, perm]
        else:
            out[k] = v
    edges = jax_cells_to_edges(out["cells"][0])
    snd, rcv, _, copies = tie_topology(edges.senders, edges.receivers, n)
    return out, snd, rcv, n, copies


def _jax_topology(model, snd, rcv, n):
    from hyper_graph_nets_tpu.core.mesh import receivers_to_gather as jax_receivers_to_gather
    from hyper_graph_nets_tpu.models.base import Topology as JTopology, try_band_plan

    gidx, gval = jax_receivers_to_gather(rcv, n)
    sidx, sval = jax_receivers_to_gather(snd, n)
    return JTopology(snd, rcv, n, gather_idx=gidx, gather_valid=gval, snd_gather_idx=sidx,
                     snd_gather_valid=sval, band_plan=try_band_plan(snd, rcv, n))


def test_fused_path_leaves_a_rejected_mesh_unfused_and_matches_jax(monkeypatch):
    """ROADMAP section 3, item 4: on a mesh whose numbering the JAX fused
    kernel's band criterion rejects, the port builds no segment plan, so
    ``agg_vjp: fused`` runs the mesh set unfused (K1's wrapper is never
    entered), with tied max/min cotangents split as autograd splits them,
    as the JAX package does there; loss and gradients against the JAX
    ``fused`` path's (float32). Off the CPU (here the meta device) the
    dropped plan warns, since the card then runs no K1/K2 for the set.
    The mesh-edge encoder's gradients are held by relative L2 norm within
    5e-4 (measured 9.7e-5): they scale with the mesh-edge normalizer's
    statistics, float32 sums over 27,700 rows that cancel (the mesh edge
    lengths take a few values), summed in another order in each package."""
    from hyper_graph_nets_tpu.ops.pallas.fused_block import check_banded as jax_check_banded

    traj, snd, rcv, n, copies = _permuted_tie_case()
    config = flag_config(None, agg_vjp="fused")
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4)
    jmodel, model = jax_get_model(config), get_model(config)
    jtopo, topo = _jax_topology(jmodel, snd, rcv, n), model.topology_from_edges(snd, rcv, n)
    assert not jax_check_banded(snd, rcv) and jtopo.band_plan is None
    assert topo.plan is None and len(copies) > 100
    with pytest.warns(UserWarning, match="band criterion"):
        assert model.topology_from_edges(snd, rcv, n, device="meta").plan is None

    def no_k1(*args, **kwargs):
        raise AssertionError("K1's wrapper entered on an unplanned mesh")

    monkeypatch.setattr(fused_block, "fused_edge_block", no_k1)
    jstate = jmodel.init_state(jax.random.PRNGKey(0))
    frames_np = _frames(traj)
    frames = {k: jnp.asarray(v) for k, v in frames_np.items()}
    _, _, jstate = jmodel.make_graph(jstate, jtopo, frames, True)
    jstate = jmodel.get_target(jstate, frames, True)[1]

    step_key = jax.random.PRNGKey(5)
    want_loss, want_grads, _ = _jax_loss_and_grads(jmodel, jstate, jtopo, frames_np, step_key)
    trainer = Trainer(model, config, device="cpu")
    tstate = trainer.init_train_state(state=state_from_jax_numpy(*_numpy_state(jstate)))
    normal, _ = jax_draws(step_key, frames_np["world_pos"].shape, (1,))
    loss, _ = trainer.loss_and_grads(tstate, topo, trainer.frames(frames_np), normal=normal)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_grads_close(tstate.model.params, want_grads, "edge_encoders.mesh_edges.", 5e-4)


@pytest.mark.parametrize("E, N, hot", [(0, 5, 0), (1, 5, 0), (300, 40, 0), (3000, 40, 1200), (50, 200, 0)])
def test_fixed_order_sums_equal_index_add(E, N, hot):
    """ROADMAP section 3, item 5: the fixed-order segment sum (float64, so
    that the order cannot show) equals ``index_add_`` forward and backward,
    with a segment of ``hot`` edges (several levels); so does the gather,
    whose backward is the sum; added rows stay 0."""
    rng = np.random.default_rng(E)
    ids = rng.integers(0, N, E).astype(np.int64)
    ids[:hot] = 2
    plan = segment_ops.fixed_sum_plan(ids, N)
    tids = torch.from_numpy(ids)
    x = torch.tensor(rng.normal(size=(2, E, 3)), requires_grad=True)
    y = torch.tensor(rng.normal(size=(2, N, 3)), requires_grad=True)
    gy, ge = torch.tensor(rng.normal(size=(2, N, 3))), torch.tensor(rng.normal(size=(2, E, 3)))
    got = segment_ops.segment_sum_fixed(x, plan)
    want = torch.zeros(2, N, 3, dtype=torch.float64).index_add_(1, tids, x)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    if E:
        torch.testing.assert_close(torch.autograd.grad(got, x, gy)[0], torch.autograd.grad(want, x, gy)[0])
    got, want = segment_ops.gather_fixed(y, plan), y[:, tids]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if E:
        torch.testing.assert_close(torch.autograd.grad(got, y, ge)[0], torch.autograd.grad(want, y, ge)[0],
                                   rtol=1e-12, atol=1e-12)
    more = segment_ops.segment_sum_fixed(x, plan.with_rows(N + 3))
    assert more.shape[1] == N + 3 and bool((more[:, N:] == 0).all())


def test_unplanned_sets_sum_in_fixed_order(monkeypatch):
    """ROADMAP section 3, item 5: a train step of ``hyper`` with the
    balancer on the ``xla`` path (every set unfused) makes no
    ``index_add_`` call in its sums, and each set's edge update gathers
    through the fixed-order sums: 2 gathers of 5 sets (mesh, balance, up,
    down, inter) in each of 2 blocks, each summed in its backward."""
    config = rmp_config("hyper", None, "xla", noise=0.003, gamma=0.9, **_balancer(True))
    traj = _trajectory()
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    tstate = trainer.init_train_state()
    topo = model.topology_from_trajectory(traj)
    static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    backward = segment_ops._GatherFixed.backward
    calls = []

    def no_index_add(*args, **kwargs):
        raise AssertionError("index_add_ on an unplanned set")

    def counted(ctx, g):
        calls.append(ctx.plan.num_segments)
        return backward(ctx, g)

    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    monkeypatch.setattr(segment_ops._GatherFixed, "backward", staticmethod(counted))
    loss, _ = trainer.loss_and_grads(tstate, topo, trainer.frames(_frames(traj)), static=static,
                                     generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    assert len(calls) == 2 * 5 * 2 and set(calls) == {NX * NX + K}
