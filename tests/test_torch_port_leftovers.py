"""The rest of the port's leftovers against the JAX package: ``aggregation:
std``, ``model.remat``, ``utils.config.initialize_config`` and plate's
``test_world_edge_truncated`` scalar.

Tolerances, float32: the std aggregate and its gradient rtol 1e-5, atol
1e-6 (sums in another order), NaN where JAX's is NaN; a train step's loss
rtol 1e-5 and each gradient rtol 1e-4 and atol 1e-5 of its largest element
(``torch_port_models.assert_grads_close``, as the cylinder and plate
tests), with std 1e-3 of it (``_assert_std_grads_close`` says why); remat against no remat in the port: equal bit for bit; the task's
scalars rtol 1e-5 and the truncation count equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.core import segment_ops as jsegment_ops
from hyper_graph_nets_tpu.utils.config import initialize_config as jax_initialize_config
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
from hyper_graph_nets_tpu_torch.data import synthetic
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.nn import meshgraphnet
from hyper_graph_nets_tpu_torch.ops import fused_block
from hyper_graph_nets_tpu_torch.utils.config import initialize_config
from torch_port_models import ModelPair, assert_grads_close

# receivers 1 and 2 have no edge, receiver 3 one edge, receiver 4 two equal
# edges (no spread), receiver 5 a valid edge and a masked one
STD_RECEIVERS = np.array([0, 0, 0, 3, 4, 4, 5, 5], np.int32)
STD_MASK = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
STD_ROWS = 6


def _std_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(STD_RECEIVERS), 5)).astype(np.float32)
    x[5] = x[4]
    w = rng.normal(size=(STD_ROWS, 5)).astype(np.float32)
    return x, w


def _assert_same_with_nans(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("path", ["scatter", "scatter_fixed_order", "gather"])
def test_std_aggregate_and_its_gradient_match_jax(path):
    """``std`` over the scatter path (``aggregate``, with and without the
    fixed-order sums) and over the neighbour matrix (``gather_aggregate``)
    against the JAX package's ``aggregate`` and ``gather_aggregate``:
    ``sqrt(max(E[x^2] - mean^2, 0))``, 0 for a receiver without an edge.

    The gradient at a receiver with no spread (one edge, or two equal
    ones) is JAX's: ``maximum`` splits the cotangent at its tie with 0 and
    ``sqrt``'s derivative is infinite at 0, so each such receiver's edges
    get NaN.  On the scatter path so does a masked edge of such a receiver
    (0 x NaN); on the neighbour matrix a masked edge has no entry (0), but
    edge 0, which every row's padding entries name at weight 0, takes NaN
    from the rows without spread.  The port matches it element for element
    rather than smoothing it away."""
    x, w = _std_case()
    rcv, mask = STD_RECEIVERS, STD_MASK
    if path == "gather":
        gidx, gvalid = receivers_to_gather(rcv, STD_ROWS, mask=mask)
        jfn = lambda d: jsegment_ops.gather_aggregate(d, jnp.asarray(gidx), jnp.asarray(gvalid), "std")
        fn = lambda d: segment_ops.gather_aggregate(d, torch.tensor(gidx), torch.tensor(gvalid), "std")
    else:
        sums = segment_ops.fixed_sum_plan(rcv, STD_ROWS, mask) if path == "scatter_fixed_order" else None
        jfn = lambda d: jsegment_ops.aggregate(d, jnp.asarray(rcv), STD_ROWS, "std", jnp.asarray(mask))
        fn = lambda d: segment_ops.aggregate(d, torch.tensor(rcv), STD_ROWS, "std", torch.tensor(mask), sums=sums)
    want = jfn(jnp.asarray(x))
    jgrad = jax.grad(lambda d: jnp.sum(jfn(d) * w))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = fn(t)
    (got * torch.tensor(w)).sum().backward()
    _assert_same_with_nans(got.detach(), want)
    _assert_same_with_nans(t.grad, jgrad)
    g = t.grad.numpy()
    assert np.isnan(g[3:7]).all()
    if path == "gather":
        assert np.isnan(g[0]).all() and np.isfinite(g[1:3]).all() and not g[7].any()
    else:
        assert np.isfinite(g[:3]).all() and np.isnan(g[7]).all()
    assert not np.asarray(want)[1:3].any()


def _cylinder(num_steps=8):
    return add_targets(synthetic.cylinder_trajectory(num_steps=num_steps, nx=7, ny=5, seed=1), "velocity", False)


@pytest.mark.parametrize("agg_vjp", ["xla", "gather"])
def test_std_train_step_matches_jax(agg_vjp):
    """Cylinder (2 blocks, latent 16) with ``aggregation: std``: one train
    step on 4 frames with JAX's noise, the loss and every gradient (finite:
    each mesh receiver has several edges with distinct latents)."""
    pair = ModelPair("cylinder", _cylinder(), agg_vjp, aggregation="std")
    key = jax.random.PRNGKey(2)
    jloss, jgrads, _ = pair.jax_loss_and_grads(key, slice(1, 5))
    _, ts, loss, _ = pair.port_train_step(key, slice(1, 5))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert all(torch.isfinite(p.grad).all() for p in ts.model.params.parameters())
    _assert_std_grads_close(ts.model.params, jgrads)


def _assert_std_grads_close(params, jgrads):
    """Each gradient within 1e-3 of its largest element plus 1e-6 of the
    largest gradient of any parameter.  Looser than pna's limits: the
    variance is a difference of two float32 means (measured worst 6.5e-5
    of a parameter's largest element, against 5.4e-7 with pna on the same
    step); and the last block's edge LayerNorm bias has an exact gradient of
    0 (a std does not change when its edges shift together), which each
    package's rounding fills with noise of about 1e-10."""
    want = {n: p.detach().numpy() for n, p in jgrads.named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in params.named_parameters():
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        assert err <= 1e-3 * float(np.abs(want[name]).max()) + 1e-6 * scale, (name, err)


def test_fused_with_std_warns_and_runs_unfused(monkeypatch):
    """``agg_vjp: fused`` with ``aggregation: std`` warns, as the JAX
    package does, and every set runs unfused: no K1 call, and the step is
    the ``xla`` path's bit for bit and JAX's fused-config step."""
    traj = _cylinder()
    with pytest.warns(UserWarning, match="aggregation 'pna'"):
        pair = ModelPair("cylinder", traj, "fused", jax_agg="fused", aggregation="std")
    assert pair.topo.plan is not None

    def no_kernel(*args, **kwargs):
        raise AssertionError("K1 ran with aggregation std")

    monkeypatch.setattr(fused_block, "fused_edge_block", no_kernel)
    key = jax.random.PRNGKey(2)
    jloss, jgrads, _ = pair.jax_loss_and_grads(key, slice(1, 5))
    _, ts, loss, _ = pair.port_train_step(key, slice(1, 5))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_std_grads_close(ts.model.params, jgrads)
    _, xts, xloss, _ = ModelPair("cylinder", traj, "xla", aggregation="std").port_train_step(key, slice(1, 5))
    assert loss == xloss
    for p, q in zip(ts.model.params.parameters(), xts.model.params.parameters()):
        assert torch.equal(p.grad, q.grad)


# -- remat -----------------------------------------------------------------------------


def _grads(ts):
    return {n: p.grad.clone() for n, p in ts.model.params.named_parameters()}


@pytest.mark.parametrize("agg_vjp", ["fused", "sorted", "gather", "xla"])
def test_remat_is_bit_for_bit_and_matches_jax(agg_vjp):
    """``model.remat: true`` on cylinder (2 blocks): each processor block
    runs through ``torch.utils.checkpoint`` under autograd and its backward
    recomputes it (the fused path's K1 plain version again, then K2's); the
    loss and every gradient equal those without remat bit for bit, and match
    the JAX package's step with ``remat`` (its ``jax.checkpoint``; the JAX
    side on ``gather`` where the port runs ``fused``, the tie rule both
    share, as tests/test_torch_port_cylinder.py does)."""
    traj = _cylinder()
    key = jax.random.PRNGKey(2)
    jax_agg = "gather" if agg_vjp == "fused" else None
    plain = ModelPair("cylinder", traj, agg_vjp, jax_agg=jax_agg)
    _, pts, ploss, _ = plain.port_train_step(key, slice(1, 5))
    remat = ModelPair("cylinder", traj, agg_vjp, jax_agg=jax_agg, remat=True)
    assert remat.model.gnn_config.remat and remat.jmodel.gnn_config.remat
    calls = []
    checkpoint = meshgraphnet.checkpoint
    meshgraphnet.checkpoint = lambda *a, **k: calls.append(1) or checkpoint(*a, **k)
    try:
        _, rts, rloss, _ = remat.port_train_step(key, slice(1, 5))
    finally:
        meshgraphnet.checkpoint = checkpoint
    assert len(calls) == 2
    assert rloss == ploss
    got, want = _grads(rts), _grads(pts)
    assert all(torch.equal(got[n], want[n]) for n in want)
    jloss, jgrads, _ = remat.jax_loss_and_grads(key, slice(1, 5))
    np.testing.assert_allclose(rloss, jloss, rtol=1e-5)
    assert_grads_close(rts.model.params, jgrads)


def test_remat_under_rmp_and_without_autograd():
    """Hierarchical blocks (flag, k-means RMP with the hyper connector, the
    fused path) with remat: the step with its static equals the one
    without bit for bit; a forward without autograd (serving) calls no
    checkpoint."""
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer
    from test_torch_port_bucketing import _config

    rmp = {
        "clustering": "kmeans", "connector": "hyper", "num_clusters": 3, "hyper_noise": 0.005,
        "hyper_node_features": True, "frequency": 1, "fully_connect": False,
        "intra_cluster_sampling": {"enabled": False, "alpha": 0.1, "spotter_threshold": 0},
    }
    traj = add_targets(synthetic.flag_trajectory(num_steps=6, nx=6, ny=6), "world_pos", True)
    runs = []
    for remat in (False, True):
        config = _config("fused", rmp=rmp, remat=remat)
        model = get_model(config)
        trainer = Trainer(model, config, device="cpu")
        ts = trainer.init_train_state(torch.Generator().manual_seed(0))
        topo = model.topology_from_trajectory(traj, device="cpu")
        static = trainer.expansion.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
        frames = trainer.frames({k: v[:4] for k, v in traj.items()})
        normal = torch.randn(frames["world_pos"].shape, generator=torch.Generator().manual_seed(1))
        hyper = torch.randn(trainer.expansion.hyper_noise_shape(model, frames, static),
                            generator=torch.Generator().manual_seed(2))
        loss, _ = trainer.loss_and_grads(ts, topo, frames, normal=normal, static=static, hyper_normal=hyper)
        runs.append((loss, _grads(ts)))
        assert model.gnn_config.architecture == "hyper" and model.gnn_config.remat == remat
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1) and all(torch.equal(g0[n], g1[n]) for n in g0)

    checkpoint = meshgraphnet.checkpoint
    meshgraphnet.checkpoint = lambda *a, **k: pytest.fail("checkpoint without autograd")
    try:
        with torch.no_grad():
            graph, _, _ = model.make_graph(ts.model, topo, frames, False)
            graph, _ = trainer.expansion.expand(ts.model, graph, frames, model, is_training=False, static=static)
            model.forward(ts.model, graph)
    finally:
        meshgraphnet.checkpoint = checkpoint


# -- initialize_config -----------------------------------------------------------------


def test_initialize_config_matches_jax():
    """The processed params of a cw2-style config at two repetitions, with
    ``log_`` keys (positive and negative ints, a float, one below -30),
    integer-valued floats, nested dicts and both seed modes, equal to the
    JAX package's; the input is left as it was; the two misuses raise."""
    config = {
        "name": "exp", "_experiment_name": "grid", "iterations": 7, "_rep_log_path": "/logs",
        "params": {
            "random_seeds": {"numpy": "default", "pytorch": "tied"},
            "model": {"log_latent": 7, "log_lr": -3, "log_eps": -40, "log_scale": 0.5, "steps": 15.0,
                      "noise": 0.003, "inner": {"log_width": 4, "ratio": 2.0}},
            "task": {"dataset": "flag_simple"},
        },
    }
    for repetition in (0, 3):
        before = repr(config)
        got = initialize_config(config, repetition)
        assert got == jax_initialize_config(config, repetition)
        assert repr(config) == before
    assert got["model"]["latent"] == 128 and got["model"]["eps"] == 0 and got["random_seeds"]["pytorch"] == 3
    for bad in ({"params": {"_recording_structure": {}}}, {"params": {"iterations": 1}}):
        with pytest.raises(ValueError):
            initialize_config(bad)


# -- test_world_edge_truncated ---------------------------------------------------------


def test_plate_scalars_report_world_edge_truncation(tmp_path, monkeypatch):
    """Plate (2 blocks, latent 16, an 18x18 plate) with a world-edge capacity
    of 1, which the stamp's contact overfills (up to 6 hits a frame in the
    8 test frames): both packages' tasks on the same synthetic
    data and state report ``test_world_edge_truncated``, the drops summed
    over the one-step, rollout and n-step evaluations, with the same count
    (nonzero) and the same other scalars.  Before this, the port's scalars
    had only the four losses, so the drops went unreported."""
    from hyper_graph_nets_tpu.training import task as jax_task_module
    from hyper_graph_nets_tpu.training.task import MeshTask as JaxMeshTask
    from hyper_graph_nets_tpu_torch.convert import train_state_from_jax_numpy
    from hyper_graph_nets_tpu_torch.training.task import get_task
    from test_torch_port_bucketing import _capped
    from test_torch_port_task import _jax_numpy
    from torch_port_models import cut_config

    monkeypatch.setattr(jax_task_module, "animate_rollout", lambda *a, **k: None)
    config = cut_config("plate", max_world_edges=1, n_step_chunk=4)
    config["params"]["task"].update(
        batch_size=4, epochs=1, n_timesteps=8, trajectories=1,
        synthetic={"trajectories": 2, "num_steps": 10, "nx": 18, "ny": 18},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": 2},
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
    )
    jtask = JaxMeshTask(config, data_dir=str(tmp_path))
    jtask.tstate = _capped(jtask.simulator.model, jtask.tstate, next(iter(jtask._train_data())))
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.tstate = train_state_from_jax_numpy(task.simulator.trainer, *_jax_numpy(jtask.tstate))
    with pytest.warns(UserWarning, match="radius-query hits"):
        got = task.get_scalars()
    want = jtask.get_scalars()
    assert got.keys() == want.keys() == {"test_loss", "test_position_error", "test_rollout_loss", "test_n_step_loss",
                                         "test_world_edge_truncated"}
    assert got["test_world_edge_truncated"] == want["test_world_edge_truncated"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
