"""Cross-trajectory bucketing of the port against the JAX package's.

Meshes of two sizes (the JAX package's tests/test_bucketing.py flags: 4x4
and 6x5, so 16 and 30 nodes under a capacity of 30) padded to one capacity:
the padding, the capacity and the padded topologies array for array, the
bucket's band decision, the padded normalizer statistics,
``fit_trajectory`` on the fused and the sorted paths, the three
evaluators, the control (the port's old per-trajectory rollout loss misses
JAX's by n / C), a finding in the JAX package's bucketed rollouts, and RMP
with the padded nodes out of every cluster.  The task loop and plate are in
tests/test_torch_port_bucketing_task.py.

The port starts from the JAX simulator's state (``convert``) and trains
with JAX's noise draws (``test_torch_port_task.jax_noise``).  That state's
normalizers have seen the first trajectory in training mode and sit at
their accumulation cap (``_capped``), as chip_smoke.py's card-against-CPU
checks hold them: each package sums a padded batch's masked statistics in
another order, and on the synthetic grids' symmetric edges a difference of
one ulp in a statistic decides near ties of the pna max and min (measured
from fresh normalizers: 2.7e-3 relative L2 between the packages' gradients
of the edge encoder's first layer after one padded step, against 5e-6
unpadded).  The masked accumulation itself is held on its own
(``test_padded_normalizer_accumulation_matches_jax``).  Tolerances,
float32, as tests/test_torch_port_task.py: losses and evaluator scalars
rtol 1e-5 (the same operations, summed in another order); rollout
positions rtol 1e-5, atol 1e-6; parameters after a fit atol 1e-6 (0.1 lr
where the first Adam step's gradient lies within 10 eps of 0, as there);
normalizers rtol 1e-5 and atol 1e-5 of the field's largest magnitude.
Index arrays, masks, capacities and band decisions are equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data import bucketing as jbucketing
from hyper_graph_nets_tpu.data import synthetic as jsynthetic
from hyper_graph_nets_tpu.data.preprocessing import add_targets
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.training.simulator import MeshSimulator as JaxMeshSimulator
from hyper_graph_nets_tpu_torch.convert import train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.data import bucketing
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
from test_torch_port_task import _assert_state_close, _jax_numpy, jax_noise
from torch_port_cases import flag_config

N_TIMESTEPS, N_STEP = 8, 3
PLATE_TIMESTEPS = 4  # one batch a plate trajectory


def _flag(nx, ny, seed=0, steps=10):
    return add_targets(jsynthetic.flag_trajectory(num_steps=steps, nx=nx, ny=ny, seed=seed), "world_pos", True)


def _plate(nx, ny, seed=0, steps=10):
    return add_targets(jsynthetic.plate_trajectory(num_steps=steps, nx=nx, ny=ny, seed=seed), "world_pos", False)


def two_flags():
    return _flag(4, 4), _flag(6, 5, seed=1)


def _config(agg_vjp="fused", dataset="flag_minimal", **model):
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["task"] = {
        "task": "mesh", "dataset": dataset, "batch_size": 4, "epochs": 1, "n_timesteps": N_TIMESTEPS,
        "trajectories": 1,
        "test": {"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": N_STEP},
        "validation": {"trajectories": 1, "rollouts": 1, "n_viz": 1},
    }
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4, n_step_chunk=4, **model)
    config["params"]["random_seed"] = 0
    return config


def _plate_config(max_world_edges="auto"):
    from torch_port_models import cut_config

    config = cut_config("plate", max_world_edges=max_world_edges, n_step_chunk=4)
    config["params"]["task"].update(batch_size=4, n_timesteps=PLATE_TIMESTEPS)
    config["params"]["random_seed"] = 0
    return config


def _capped(jmodel, jts, traj):
    """The JAX train state with its normalizers accumulated over ``traj``
    in training mode, then at their accumulation cap."""
    topo = jmodel.topology_from_trajectory(traj)
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    _, _, ms = jmodel.make_graph(jts.model, topo, frames, True)
    _, ms = jmodel.get_target(ms, frames, True)
    capped = {k: v.replace(num_accumulations=jnp.full_like(v.num_accumulations, v.max_accumulations))
              for k, v in ms.normalizers.items()}
    return jts.replace(model=ms.replace(normalizers=capped))


def _pair(config, root, trajs):
    """Both simulators at the bucket's capacity (with JAX's band decision
    and bucket dims on the JAX side and the port's on the port side) on the
    JAX simulator's initial state (normalizers :func:`_capped`), the port
    drawing JAX's noise."""
    jsim = JaxMeshSimulator(config, out_dir=str(root / "jax"))
    jts = _capped(jsim.model, jsim.initialize(), trajs[0])
    sim = MeshSimulator(config, out_dir=str(root / "port"), device="cpu")
    sim.initialize()
    ts = train_state_from_jax_numpy(sim.trainer, *_jax_numpy(jts))
    sim._normal = jax_noise(jsim._key)
    n, e = bucketing.trajectory_capacity(trajs)
    jscan = [jsim._maybe_reorder(t) for t in trajs]
    scan = [sim._maybe_reorder(t) for t in trajs]
    jsim.set_capacity(n, e, plan_dims=jbucketing.bucket_plan_dims(jsim.model, jscan, n, e),
                      topo_extras=jsim.model.bucket_topology_extras(jscan))
    sim.set_capacity(n, e, plan_dims=bucketing.bucket_plan_dims(sim.model, scan, n, e),
                     topo_extras=sim.model.bucket_topology_extras(scan))
    return jsim, jts, sim, ts


def _assert_topology_equal(topo, jtopo):
    for f in ("senders", "receivers", "mask", "gather_idx", "gather_valid", "snd_gather_idx", "snd_gather_valid"):
        np.testing.assert_array_equal(getattr(topo, f).numpy(), np.asarray(getattr(jtopo, f)), err_msg=f)
    assert topo.num_nodes == jtopo.num_nodes and topo.world_cap == jtopo.world_cap
    assert (topo.aux is None) == (jtopo.aux is None)
    for k, v in (jtopo.aux or {}).items():
        np.testing.assert_array_equal(topo.aux[k].numpy(), np.asarray(v), err_msg=k)


# -- padding, capacity and topologies ------------------------------------------------


@pytest.mark.parametrize("agg_vjp", ["fused", "sorted", "gather"])
def test_padding_capacity_and_topology_match_jax(agg_vjp):
    """The capacity, the padded arrays and each padded topology equal the
    JAX package's; the fused path's plan exists where JAX's band plan does
    (both meshes here), the sorted path's plan covers the valid prefix, and
    the fixed-order sums add the padded tail after the valid edges."""
    t1, t2 = two_flags()
    assert bucketing.trajectory_capacity([t1, t2]) == jbucketing.trajectory_capacity([t1, t2]) == (30, 138)
    config = _config(agg_vjp)
    jmodel, model = jax_get_model(config), get_model(config)
    for t in (t1, t2):
        padded, jpadded = bucketing.pad_trajectory(t, 30), jbucketing.pad_trajectory(t, 30)
        assert padded.keys() == jpadded.keys()
        for k in padded:
            np.testing.assert_array_equal(padded[k], jpadded[k], err_msg=k)
        topo = bucketing.pad_topology(model, padded, 30, 138)
        jtopo = jbucketing.pad_topology(jmodel, jpadded, 30, 138)
        _assert_topology_equal(topo, jtopo)
        valid = int(topo.mask.sum())
        if agg_vjp == "fused":
            assert topo.plan is not None and jtopo.band_plan is not None
            assert topo.plan.num_edges == 138 and int(topo.plan.row_ptr[-1]) == valid
        elif agg_vjp == "sorted":
            assert topo.plan.span == valid
        for plan in (topo.sums.receivers, topo.sums.senders):
            assert (plan.rest is not None) == (valid < 138)
    assert bucketing.pad_trajectory(t2, 30) is t2
    assert (bucketing.pad_trajectory(t1, 30)["node_type"][:, 16:] == bucketing.PAD_NODE_TYPE).all()
    dataset, jdataset = bucketing.BucketedDataset([t1, t2], model), jbucketing.BucketedDataset([t1, t2], jmodel)
    assert (dataset.num_nodes, dataset.num_edges) == (jdataset.num_nodes, jdataset.num_edges)
    for got, want in zip(dataset, jdataset):
        np.testing.assert_array_equal(got["world_pos"], want["world_pos"])
        _assert_topology_equal(dataset.topology(got), jdataset.topology(want))


def test_band_decision_matches_jax():
    """A bandable bucket gets the JAX package's pinned dims (which the port
    accepts and ignores) and every mesh a K1/K2 plan; a bucket with one
    randomly relabelled 50x50 grid, whose windows pass 2048, is ``"off"`` on
    both sides and no mesh in it gets a plan; off the fused path there is no
    decision."""
    t1, t2 = two_flags()
    trajs = [t1, t2, _flag(7, 7)]
    config = _config("fused")
    jmodel, model = jax_get_model(config), get_model(config)
    n, e = bucketing.trajectory_capacity(trajs)
    dims = bucketing.bucket_plan_dims(model, trajs, n, e)
    assert isinstance(dims, dict) and dims == jbucketing.bucket_plan_dims(jmodel, trajs, n, e)
    for t in trajs:
        assert bucketing.pad_topology(model, bucketing.pad_trajectory(t, n), n, e, plan_dims=dims).plan is not None

    big = _flag(50, 50, steps=3)
    relabel = np.random.default_rng(3).permutation(2500).astype(np.int32)
    shuffled = {k: (relabel[v] if k == "cells" else v[:, np.argsort(relabel)]) for k, v in big.items()}
    bucket = [t1, shuffled]
    n, e = bucketing.trajectory_capacity(bucket)
    assert bucketing.bucket_plan_dims(model, bucket, n, e) == jbucketing.bucket_plan_dims(jmodel, bucket, n, e) == "off"
    for t in bucket:
        padded = bucketing.pad_trajectory(t, n)
        assert bucketing.pad_topology(model, padded, n, e, plan_dims="off").plan is None
        assert jbucketing.pad_topology(jmodel, padded, n, e, plan_dims="off").band_plan is None
    unfused = _config("xla")
    assert bucketing.bucket_plan_dims(get_model(unfused), trajs, 49, 1) is None


def test_padded_normalizer_accumulation_matches_jax():
    """``make_graph`` and ``get_target`` in training mode over the padded 4x4
    flag's frames: every normalizer's statistics as the JAX package's (the
    padded rows stay out of the node and edge statistics; ``output``
    counts them as zeros in both), rtol 1e-5 and atol 1e-5 of the field's
    largest magnitude (masked sums in another order)."""
    from test_torch_port_task import NORMALIZER_FIELDS

    t1, t2 = two_flags()
    padded = bucketing.pad_trajectory(t1, 30)
    config = _config("xla")
    jmodel, model = jax_get_model(config), get_model(config)
    jstate = jmodel.init_state(jax.random.PRNGKey(0))
    jframes = {k: jnp.asarray(v[:4]) for k, v in padded.items() if k != "cells"}
    jtopo = jbucketing.pad_topology(jmodel, padded, 30, 138)

    def accumulate(jstate, jframes):
        _, _, jstate = jmodel.make_graph(jstate, jtopo, jframes, True)
        return jmodel.get_target(jstate, jframes, True)[1]

    jstate = jax.jit(accumulate)(jstate, jframes)
    state = model.init_state()
    frames = {k: torch.as_tensor(v[:4]) for k, v in padded.items() if k != "cells"}
    _, _, state = model.make_graph(state, bucketing.pad_topology(model, padded, 30, 138), frames, True)
    _, state = model.get_target(state, frames, True)
    assert float(state.normalizers["node"].acc_count) == 4 * 16
    assert float(state.normalizers["output"].acc_count) == 4 * 30
    for name, ns in jstate.normalizers.items():
        for f in NORMALIZER_FIELDS:
            want = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(getattr(state.normalizers[name], f).numpy(), want, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(want).max()), err_msg=f"{name}.{f}")


# -- the simulator -------------------------------------------------------------------


class _Bucketed:
    """Both simulators after fitting the 4x4 flag, then the 6x5, at their
    capacity of 30 nodes."""

    def __init__(self, root, agg_vjp):
        self.trajs = two_flags()
        self.jsim, jts, self.sim, ts = _pair(_config(agg_vjp), root, list(self.trajs))
        self.first_grads = {}
        loss_and_grads = self.sim.trainer.loss_and_grads

        def recording(tstate, *args, **kwargs):
            out = loss_and_grads(tstate, *args, **kwargs)
            if not self.first_grads:
                self.first_grads = {n: p.grad.clone() for n, p in tstate.model.params.named_parameters()}
            return out

        self.sim.trainer.loss_and_grads = recording
        self.losses, self.jlosses = [], []
        for traj in self.trajs:
            jts, jl = self.jsim.fit_trajectory(jts, traj)
            ts, lo = self.sim.fit_trajectory(ts, traj)
            self.jlosses.append(jl)
            self.losses.append(lo)
        self.jts, self.ts = jts, ts


@pytest.fixture(scope="module", params=["fused", "sorted"])
def bucketed(request, tmp_path_factory):
    return _Bucketed(tmp_path_factory.mktemp(f"bucket_{request.param}"), request.param)


def test_fit_trajectory_over_two_sizes_matches_jax(bucketed):
    """Both trajectories' batch losses (two batches of 4 frames each), and
    the parameters, normalizers and step after them."""
    for got, want in zip(bucketed.losses, bucketed.jlosses):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_state_close(bucketed.ts, bucketed.jts, bucketed.first_grads)
    topos = list(bucketed.sim._topo_cache.values())
    assert all(t is None or t.num_nodes == 30 for t in topos)


def test_evaluators_over_two_sizes_match_jax(bucketed):
    """The one-step, rollout and n-step evaluators of each size: scalars,
    the per-step curve and the padded rollout (its padded rows held at 0).
    The JAX model's compiled rollouts are cleared before each trajectory
    (see :func:`test_jax_bucketed_rollout_reuses_its_first_mesh`)."""
    sim, jsim, ts, jts = bucketed.sim, bucketed.jsim, bucketed.ts, bucketed.jts
    for traj in bucketed.trajs:
        jsim.model._fn_cache.clear()
        got = sim.one_step_evaluator(ts, [traj], logging=False)
        want = jsim.one_step_evaluator(jts, [traj], logging=False)
        for k in ("validation_loss", "position_error"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        got = sim.rollout_evaluator(ts, [traj], num_steps=N_TIMESTEPS, logging=False, save=False)
        want = jsim.rollout_evaluator(jts, [traj], num_steps=N_TIMESTEPS, logging=False, save=False)
        np.testing.assert_allclose(got["mse_curve"], want["mse_curve"], rtol=1e-5)
        np.testing.assert_allclose(got["rollout_loss"], want["rollout_loss"], rtol=1e-5)
        pred, jpred = got["rollouts"][0]["pred_pos"], np.asarray(want["rollouts"][0]["pred_pos"])
        assert pred.shape == jpred.shape == (N_TIMESTEPS, 30, 3)
        np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-6)
        n = traj["node_type"].shape[1]
        assert not pred[:, n:].any()
        got = sim.n_step_evaluator(ts, [traj], n_step=N_STEP, num_timesteps=N_TIMESTEPS, logging=False)
        want = jsim.n_step_evaluator(jts, [traj], n_step=N_STEP, num_timesteps=N_TIMESTEPS, logging=False)
        for k in ("n_step_loss", "n_step_last_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_jax_bucketed_rollout_reuses_its_first_mesh(bucketed):
    """A finding in the JAX package (ROADMAP section 3): its model caches a
    compiled rollout and n-step window by the topology's shapes
    (``models/flag.py`` ``rollout``, ``n_step_computation``), and every
    bucketed topology has the same shapes, so the second mesh of a bucket
    is rolled out over the first mesh's edges.  The port builds each step
    from the trajectory's own topology: its rollout of the 6x5 flag after
    the 4x4 one is JAX's with a cleared cache, and JAX's cached one misses
    it (a relative MSE difference of several percent after 8 steps)."""
    sim, jsim, ts, jts = bucketed.sim, bucketed.jsim, bucketed.ts, bucketed.jts
    first, second = bucketed.trajs
    jsim.model._fn_cache.clear()
    jsim.rollout_evaluator(jts, [first], num_steps=N_TIMESTEPS, logging=False, save=False)
    stale = jsim.rollout_evaluator(jts, [second], num_steps=N_TIMESTEPS, logging=False, save=False)
    jsim.model._fn_cache.clear()
    fresh = jsim.rollout_evaluator(jts, [second], num_steps=N_TIMESTEPS, logging=False, save=False)
    sim.rollout_evaluator(ts, [first], num_steps=N_TIMESTEPS, logging=False, save=False)
    got = sim.rollout_evaluator(ts, [second], num_steps=N_TIMESTEPS, logging=False, save=False)
    np.testing.assert_allclose(got["mse_curve"], fresh["mse_curve"], rtol=1e-5)
    assert abs(stale["rollout_loss"] / fresh["rollout_loss"] - 1) > 1e-2


def test_control_unpadded_rollout_loss_misses_jax_by_n_over_c(bucketed, tmp_path):
    """The control: a simulator without the capacity (the port before
    bucketing) rolls the 4x4 flag out on its own 16 nodes.  Its positions
    are JAX's bucketed ones on the real rows, but its rollout and n-step
    losses are JAX's times C / n = 30 / 16: they miss by far more than the
    tolerance, and times n / C they meet it."""
    traj = bucketed.trajs[0]
    plain = MeshSimulator(_config(bucketed.sim.model.params["model"]["agg_vjp"]), out_dir=str(tmp_path), device="cpu")
    bucketed.jsim.model._fn_cache.clear()
    want = bucketed.jsim.rollout_evaluator(bucketed.jts, [traj], num_steps=N_TIMESTEPS, logging=False, save=False)
    got = plain.rollout_evaluator(bucketed.ts, [traj], num_steps=N_TIMESTEPS, logging=False, save=False)
    np.testing.assert_allclose(got["rollouts"][0]["pred_pos"], np.asarray(want["rollouts"][0]["pred_pos"])[:, :16],
                               rtol=1e-5, atol=1e-6)
    assert abs(got["rollout_loss"] / want["rollout_loss"] - 1) > 0.5
    np.testing.assert_allclose(got["rollout_loss"] * 16 / 30, want["rollout_loss"], rtol=1e-5)
    got = plain.n_step_evaluator(bucketed.ts, [traj], n_step=N_STEP, num_timesteps=N_TIMESTEPS, logging=False)
    bucketed.jsim.model._fn_cache.clear()
    want = bucketed.jsim.n_step_evaluator(bucketed.jts, [traj], n_step=N_STEP, num_timesteps=N_TIMESTEPS,
                                          logging=False)
    np.testing.assert_allclose(got["n_step_loss"] * 16 / 30, want["n_step_loss"], rtol=1e-5)


# -- RMP ---------------------------------------------------------------------------


RMP_FIELDS = ("labels", "member_mask", "sizes", "up_senders", "up_receivers", "up_mask", "down_senders",
              "down_receivers", "down_mask", "inter_senders", "inter_receivers", "inter_mask", "member_idx",
              "member_valid")


@pytest.mark.parametrize("clustering", ["kmeans", "hdbscan"])
def test_rmp_leaves_padded_nodes_out_of_every_cluster(clustering):
    """RMP flag (the hyper connector) prepared on the 4x4 flag padded to 30
    rows: the padded rows are in no cluster (k-means: every real row is in
    one; HDBSCAN: its noise is real rows only), and the clustering and the
    connector's sets equal the JAX package's, field for field."""
    from threadpoolctl import threadpool_limits

    from hyper_graph_nets_tpu.rmp.remote_message_passing import get_rmp as jax_get_rmp
    from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import get_rmp

    rmp = {
        "clustering": clustering, "connector": "hyper", "num_clusters": 3, "hyper_noise": 0.005,
        "hyper_node_features": True, "frequency": 1, "fully_connect": False,
        "intra_cluster_sampling": {"enabled": False, "alpha": 0.1, "spotter_threshold": 0},
        "hdbscan": {"max_cluster_size": 8, "min_cluster_size": 3, "min_samples": 1, "spotter_threshold": 0.9},
    }
    config = _config("xla", rmp=rmp)
    t1, t2 = two_flags()
    n, e = bucketing.trajectory_capacity([t1, t2])
    padded = bucketing.pad_trajectory(t1, n)
    frame0 = {k: v[0] for k, v in padded.items()}
    model, jmodel = get_model(config), jax_get_model(config)
    static = get_rmp(config["params"]).prepare(model, frame0, bucketing.pad_topology(model, padded, n, e))
    with threadpool_limits(1, "openmp"):  # scikit-learn's k-means as tests/test_torch_port_cluster.py runs it
        jstatic = jax_get_rmp(config["params"]).prepare(jmodel, frame0, jbucketing.pad_topology(jmodel, padded, n, e))
    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    member = host(static.member_mask)
    assert member[16:].sum() == 0 and member[:16].sum() > 0
    if clustering == "kmeans":
        assert member[:16].sum() == 16
    for f in RMP_FIELDS:
        np.testing.assert_array_equal(host(getattr(static, f)), host(getattr(jstatic, f)), err_msg=f)
