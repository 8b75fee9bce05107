"""Plate MeshGraphNets (deforming_plate) in the port against the JAX package.

Inputs: the synthetic plate (a 5x6 quad plate and a 3x3 stamp that presses
it, 39 nodes, world edges from frame 10 on), the same seeds on both sides;
``configs/plate.yaml`` cut to latent 16 and 2 blocks, float32
(``tests/torch_port_models.py``).  The JAX side runs its Pallas kernels in
interpret mode; the port, on the CPU, runs every kernel's plain version.

Tolerances:
- the generators, the world edges (senders, receivers, mask and the hits
  past the capacity), the auto capacity and the host helpers: exact;
- one_step, rollout positions and n-step losses: rtol 1e-5, atol 1e-6 of
  the field (float32, the same operations summed in another order; the
  world edges' sums run in the port's fixed order, JAX's by scatter);
  one_step is held against the same JAX path, the fused one through the
  JAX kernel in interpret mode; the fused path's rollout, n-step losses
  and gradients against JAX's ``gather`` path, which computes the same
  forward and, in float32 without ties, the same backward (JAX's own
  fused and gather gradients agree within 5e-7 relative L2 here), to keep
  the interpret-mode compiles out of the file's time;
- loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 of each tensor's largest
  element; normalizer states rtol 1e-5 (tests/test_torch_port_train.py's);
- the fixed-order frame sums against ``index_add_``: rtol 1e-6 (float32
  reordering of at most a frame's edges).

The plate is 5x6, not square: on a square grid every mesh edge has one
length, so the ``mesh_edge`` normalizer's ``|rel_mesh|`` column has no
variance, its standard deviation is float32 rounding (about 3e-5), and the
standardized column is the rounding of the batch's accumulated sum
amplified ten-thousandfold, in both packages alike (a 5x5 plate's train
step read gradients 3.7e-3 apart, relative L2, on the mesh-edge encoder;
the 5x6 one 7e-7).
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data import synthetic as jax_synthetic
from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.models.plate import PlateModel as JaxPlateModel
from hyper_graph_nets_tpu.rmp import clustering as jax_clustering
from hyper_graph_nets_tpu.rmp.connector import build_static as jax_build_static
from hyper_graph_nets_tpu.rmp.remote_message_passing import RemoteMessagePassing as JaxRMP
from hyper_graph_nets_tpu_torch.core.graph import NodeType
from hyper_graph_nets_tpu_torch.core.segment_ops import (
    EdgeSums,
    FrameSum,
    gather_fixed,
    segment_sum_fixed,
)
from hyper_graph_nets_tpu_torch.data import loader, synthetic
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.models.plate import PlateModel
from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block
from hyper_graph_nets_tpu_torch.rmp import clustering
from hyper_graph_nets_tpu_torch.rmp.connector import build_static
from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import RemoteMessagePassing
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.task import get_task
from torch_port_models import ModelPair, assert_grads_close, assert_normalizers_close, cut_config

ROLLOUT_STEPS, N_STEP, N_TIMESTEPS = 4, 2, 5
HEAVY_HITS = 9 * 12  # heavy contact: each of 9 stamp nodes hits each of the 3x4 inner plate nodes


def _traj(num_steps=20, nx=5, ny=6, seed=0):
    return add_targets(synthetic.plate_trajectory(num_steps=num_steps, nx=nx, ny=ny, seed=seed), "world_pos", False)


def _heavy_contact(traj, seed=0):
    """Every NORMAL and OBSTACLE node within one radius of each other in
    every frame (tests/test_models.py's heavy-contact plate): each obstacle
    node hits each NORMAL node."""
    traj = {k: v.copy() for k, v in traj.items()}
    nt = traj["node_type"][0][:, 0]
    close = (nt == NodeType.NORMAL) | (nt == NodeType.OBSTACLE)
    ball = 0.005 * np.random.RandomState(seed).rand(int(close.sum()), 3)
    for key in ("world_pos", "target|world_pos"):
        traj[key][:, close] = ball
    return traj


# -- data ------------------------------------------------------------------


def test_generator_and_loader_match_jax(tmp_path):
    """Byte for byte the JAX generator's arrays, and the TFRecords each
    package's loader writes and reads back."""
    for seed, (nx, ny) in ((0, (5, 5)), (3, (9, 7))):
        ours = synthetic.plate_trajectory(num_steps=12, nx=nx, ny=ny, seed=seed)
        theirs = jax_synthetic.plate_trajectory(num_steps=12, nx=nx, ny=ny, seed=seed)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k
    config = cut_config("plate")
    config["params"]["task"]["synthetic"] = {"trajectories": 2, "num_steps": 8, "nx": 5, "ny": 4}
    ours = list(loader.get_data(config, "valid", data_dir=str(tmp_path / "port")))
    theirs = list(jax_get_data(config, "valid", data_dir=str(tmp_path / "jax")))
    again = list(loader.get_data(config, "valid", data_dir=str(tmp_path / "jax")))
    assert len(ours) == len(theirs) == len(again) == 1
    for k in theirs[0]:
        np.testing.assert_array_equal(ours[0][k], theirs[0][k])
        np.testing.assert_array_equal(again[0][k], theirs[0][k])
    in_dir, _ = loader.get_directories("deforming_plate", str(tmp_path / "port"))
    jin, _ = loader.get_directories("deforming_plate", str(tmp_path / "jax"))
    assert open(f"{in_dir}/valid.tfrecord", "rb").read() == open(f"{jin}/valid.tfrecord", "rb").read()


# -- world edges -------------------------------------------------------------


def _jax_world_edges(jm, jt, world, node_type, dense, cap):
    obs = (None, None) if dense else (jnp.asarray(jt.aux["obstacle_idx"]), jnp.asarray(jt.aux["obstacle_valid"]))
    fn = lambda w, n: jm._world_edges(w, n, jnp.asarray(jt.senders), jnp.asarray(jt.receivers), *obs, world_cap=cap)
    return [np.asarray(x) for x in jax.vmap(fn)(jnp.asarray(world), jnp.asarray(node_type))]


@pytest.mark.parametrize("dense", [False, True], ids=["obstacle_index", "dense"])
@pytest.mark.parametrize("case", ["contact", "heavy_truncated"])
def test_world_edges_equal_jax(dense, case):
    """Senders, receivers, mask and the hits past the capacity, every frame
    of a batch, exactly: frames with contact at the auto capacity, and heavy
    contact (108 hits a frame) at a capacity of 24, where the radius query
    truncates and which hits survive decides the result (``torch.topk``
    keeps another subset on ties)."""
    traj = _traj() if case == "contact" else _heavy_contact(_traj(num_steps=6))
    jm, pm = JaxPlateModel(cut_config("plate")["params"]), PlateModel(cut_config("plate")["params"])
    jt, pt = jm.topology_from_trajectory(traj), pm.topology_from_trajectory(traj)
    cap = jt.world_cap if case == "contact" else 24
    want = _jax_world_edges(jm, jt, traj["world_pos"], traj["node_type"], dense, cap)
    obs = (None, None) if dense else (pt.aux["obstacle_idx"], pt.aux["obstacle_valid"])
    got = pm._world_edges(torch.tensor(traj["world_pos"]), torch.tensor(traj["node_type"]),
                          pt.senders, pt.receivers, *obs, world_cap=cap)
    for name, a, b in zip(("senders", "receivers", "mask", "truncated"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    hits = want[2].sum(axis=-1)
    if case == "contact":
        assert hits.max() > 0 and want[3].max() == 0
    else:
        assert (hits == cap).all() and (want[3] == HEAVY_HITS - cap).all()
    # one unbatched frame gives that frame's row of the batch
    one = pm._world_edges(torch.tensor(traj["world_pos"][-1]), torch.tensor(traj["node_type"][-1]),
                          pt.senders, pt.receivers, *obs, world_cap=cap)
    for a, b in zip(one, got):
        assert torch.equal(a, b[-1])


def test_auto_capacity_and_host_helpers_match_jax():
    """``max_world_edges: auto`` (the per-trajectory capacity and its cache
    key), the obstacle aux and its bucket padding, ``obstacle_mask_np`` and
    ``world_edge_receiver_nodes``, against the JAX package's."""
    params = cut_config("plate")["params"]
    jm, pm = JaxPlateModel(params), PlateModel(params)
    for traj in (_traj(), _traj(num_steps=30, nx=9, ny=9, seed=2), _heavy_contact(_traj(num_steps=6))):
        assert pm._cached_world_cap(traj) == jm._cached_world_cap(traj)
        assert pm.topology_content_key(traj) == jm.topology_content_key(traj)
        jt, pt = jm.topology_from_trajectory(traj), pm.topology_from_trajectory(traj)
        assert pt.world_cap == jt.world_cap
        for k in ("obstacle_idx", "obstacle_valid"):
            np.testing.assert_array_equal(pt.aux[k].numpy(), jt.aux[k])
        extras = pm.bucket_topology_extras([traj])
        assert extras == jm.bucket_topology_extras([traj])
        (paux, pcap), (jaux, jcap) = pm.pad_topology_aux(traj, 40, extras), jm.pad_topology_aux(traj, 40, extras)
        assert pcap == jcap and all(np.array_equal(paux[k], jaux[k]) for k in jaux)
        for t in (0, -1):
            frame = {k: v[t] for k, v in traj.items()}
            np.testing.assert_array_equal(pm.obstacle_mask_np(frame), jm.obstacle_mask_np(frame))
            a, b = pm.world_edge_receiver_nodes(frame, pt), jm.world_edge_receiver_nodes(frame, jt)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert pm._cached_world_cap(_heavy_contact(_traj(num_steps=6))) == 256


# -- the fixed-order frame sums -------------------------------------------------


def test_frame_sums_match_index_add_and_are_each_others_backward():
    """:class:`FrameSum` (the plan built where the ids lie) against a plain
    ``index_add_`` per frame, masked elements left out; gathering and summing
    are each other's backward; the same result for one frame alone."""
    rng = np.random.default_rng(3)
    B, W, N, F = 3, 37, 11, 5
    ids = torch.tensor(rng.integers(0, N, size=(B, W)))
    mask = torch.tensor((rng.random((B, W)) > 0.3).astype(np.float32))
    x = torch.tensor(rng.normal(size=(B, W, F)).astype(np.float32), requires_grad=True)
    plan = FrameSum.build(ids, mask, N)
    got = segment_sum_fixed(x, plan)
    want = torch.zeros(B, N, F).index_put_((torch.arange(B)[:, None].expand(B, W), ids), x * mask[..., None],
                                           accumulate=True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, segment_sum_fixed(x, plan))  # the same order every call
    g = torch.tensor(rng.normal(size=(B, N, F)).astype(np.float32))
    (dx,) = torch.autograd.grad(got, x, g)
    spread = torch.gather(g, 1, ids[..., None].expand(B, W, F)) * mask[..., None]
    assert torch.equal(dx, spread)
    nodes = torch.tensor(rng.normal(size=(B, N, F)).astype(np.float32), requires_grad=True)
    rows = gather_fixed(nodes, plan)
    assert torch.equal(rows, torch.gather(nodes, 1, ids[..., None].expand(B, W, F)))
    gr = torch.tensor(rng.normal(size=(B, W, F)).astype(np.float32))
    (dn,) = torch.autograd.grad(rows, nodes, gr)
    assert torch.equal(dn, plan(gr))
    one = FrameSum.build(ids[1], mask[1], N)
    assert torch.equal(one(x[1].detach()), got[1].detach())
    sums = EdgeSums.per_frame(ids.flip(-1), ids, mask, N)  # (senders, receivers, ...)
    assert torch.equal(sums.receivers.key, plan.key)
    assert torch.equal(sums.senders.key, FrameSum.build(ids.flip(-1), mask, N).key)


# -- the model ------------------------------------------------------------------


_PATHS = ["fused", "xla", "gather", "sorted"]


@pytest.mark.parametrize("agg_vjp", _PATHS)
def test_one_step_rollout_and_n_step_match_jax(agg_vjp):
    """one_step (``Predictor``) on 6 frames with contact, a 4-step rollout
    on heavy contact at a capacity of 24 (positions, MSE and the truncated
    hits), and the n-step losses, each path against the JAX package's same
    path; the fused path launches nothing on the CPU."""
    traj = _traj()
    pair = ModelPair("plate", traj, agg_vjp)
    assert (pair.topo.plan is not None) == (agg_vjp in ("fused", "sorted"))
    k1 = fused_edge_block.launches
    sl = slice(12, 18)
    want = np.asarray(pair.jax_one_step(sl))
    got = Predictor(pair.config, state=pair.state, device="cpu").one_step({k: v[sl] for k, v in traj.items()})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    jmodel, jtopo = pair.jax_path("gather") if agg_vjp == "fused" else (pair.jmodel, pair.jtopo)
    heavy = _heavy_contact(_traj(num_steps=8))
    hj = jmodel.topology_from_trajectory(heavy)._replace(world_cap=24)
    hp = pair.model.topology_from_trajectory(heavy)._replace(world_cap=24)
    with pytest.warns(UserWarning, match="radius-query hits were dropped"):
        jops, jmse = jmodel.rollout(pair.jstate, hj, heavy, num_steps=ROLLOUT_STEPS)
    with pytest.warns(UserWarning, match="radius-query hits were dropped"), torch.no_grad():
        ops, mse = pair.model.rollout(pair.state, hp, heavy, num_steps=ROLLOUT_STEPS)
    np.testing.assert_allclose(ops["pred_pos"].numpy(), np.asarray(jops["pred_pos"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(ops["mask"], jops["mask"])
    assert pair.model.pop_eval_metrics() == jmodel.pop_eval_metrics() == {
        "world_edge_truncated": ROLLOUT_STEPS * (HEAVY_HITS - 24)
    }

    jm, jl = jmodel.n_step_computation(pair.jstate, jtopo, traj, n_step=N_STEP, num_timesteps=N_TIMESTEPS)
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("error")
        m, last = pair.model.n_step_computation(pair.state, pair.topo, traj, n_step=N_STEP,
                                                num_timesteps=N_TIMESTEPS)
    np.testing.assert_allclose([m, last], [float(jm), float(jl)], rtol=1e-5)
    assert pair.model.pop_eval_metrics() == jmodel.pop_eval_metrics() == {"world_edge_truncated": 0}
    assert fused_edge_block.launches == k1


@pytest.mark.parametrize("agg_vjp", ["fused", "xla"])
def test_loss_and_gradients_match_jax(agg_vjp):
    """One train step on 6 frames with contact, JAX's noise: loss,
    gradients, normalizer states and the truncation counter (0) against
    the JAX package's."""
    traj = _traj()
    pair = ModelPair("plate", traj, agg_vjp, jax_agg="gather" if agg_vjp == "fused" else None,
                     noise=0.003, gamma=0.9)
    sl = slice(12, 18)
    key = jax.random.PRNGKey(1)
    jloss, jgrads, jnorm = pair.jax_loss_and_grads(key, sl)
    _, ts, loss, metrics = pair.port_train_step(key, sl)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_normalizers_close(ts.model.normalizers, jnorm)
    assert_grads_close(ts.model.params, jgrads)
    assert int(metrics["world_edge_truncated"]) == 0
    assert "world_edges" in dict(pair.model.gnn_config.edge_in_dims)


def test_task_loop_runs_and_counts(tmp_path):
    """``get_task(...).run_iterations()`` on a cut plate config (fused, one
    epoch of two trajectories, the evaluators, a checkpoint, the GIF), then
    ``get_scalars``: finite; the logs carry the truncation counter."""
    config = cut_config("plate")
    config["params"]["task"].update(
        batch_size=4, epochs=1, n_timesteps=6, trajectories=2,
        synthetic={"trajectories": 2, "num_steps": 8, "nx": 5, "ny": 6},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": 2},
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
    )
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.run_iterations()
    scalars = task.get_scalars()
    assert scalars and all(np.isfinite(v) for v in scalars.values())
    _, out_dir = loader.get_directories("deforming_plate", str(tmp_path))
    log = open(f"{out_dir}/run.metrics.jsonl").read()
    assert "world_edge_truncated" in log and "rollout_loss" in log


# -- HGN plate's host pieces (queue 1, item 5) ----------------------------------


def _obstacle_hosts():
    """Both packages' host graphs of the 8x8 flag's first frame with 11
    nodes marked as obstacles."""
    from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag
    from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from torch_port_cases import flag_config

    traj = jax_add_targets(jax_flag(num_steps=4, nx=8, ny=8), "world_pos", True)
    frame = {k: v[0] for k, v in traj.items()}
    obstacle = np.zeros(64, bool)
    obstacle[[3, 9, 10, 17, 30, 31, 38, 45, 52, 60, 61]] = True
    config = flag_config(None)
    jm, pm = jax_get_model(config), get_model(config)
    jhost = jm.host_graph(frame, jm.topology_from_trajectory(traj))._replace(obstacle_mask=obstacle)
    host = pm.host_graph(frame, pm.topology_from_trajectory(traj))._replace(obstacle_mask=obstacle)
    return jhost, host, obstacle


def _clusterings(name, K=4):
    jhost, host, obstacle = _obstacle_hosts()
    cfg = {"num_clusters": K}
    jrmp = JaxRMP(jax_clustering.get_clustering_algorithm(name, cfg), None)
    rmp = RemoteMessagePassing(clustering.get_clustering_algorithm(name, cfg), None)
    return jrmp._cluster_without_obstacles(jhost), rmp._cluster_without_obstacles(host), obstacle


@pytest.mark.parametrize("name", ["spectral", "random"])
def test_cluster_without_obstacles_matches_jax(name):
    """On the 8x8 flag with 11 obstacle nodes, K = 4: labels (-1 on the
    obstacles), members and neighbours equal to the JAX package's."""
    want, got, obstacle = _clusterings(name)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.labels[obstacle] == -1).all() and (got.labels[~obstacle] >= 0).all()
    assert got.neighbors == want.neighbors and got.num_clusters == want.num_clusters == 4
    assert len(got.clusters) == len(want.clusters)
    for a, b in zip(got.clusters, want.clusters):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("K", [4, 5, 6])
def test_build_static_inter_world_matches_jax(K, pad):
    """``build_static(inter_world=True, world_collide_labels=)`` on those
    clusterings: every field, the inter-world senders, receivers and mask
    among them, equal to the JAX package's, with and without the padding of
    ``_pad_static``, for three sets of collide labels."""
    jc, c, _ = _clusterings("random", K)
    for collide in ([0, 1], [1, K - 1], list(range(K))):
        labels = np.asarray(collide, np.int64)
        kw = dict(inter_world=True, world_collide_labels=labels)
        want, got = jax_build_static(jc, 64, **kw), build_static(c, 64, **kw)
        if pad:
            want, got = JaxRMP._pad_static(want), RemoteMessagePassing._pad_static(got)
        assert int(np.asarray(got.inter_world_mask).sum()) > 0
        for f in want._fields:
            if f.endswith("_plan"):  # the JAX package's band plans, None here
                assert getattr(want, f) is None, f
                continue
            a, b = getattr(got, f), getattr(want, f)
            if b is None:
                assert a is None, f
                continue
            if isinstance(b, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


def test_jax_checkpoint_serves_in_the_port(tmp_path):
    """A JAX plate checkpoint (``.pkl``: the world_edges encoder and the
    world_edge normalizer among its trees) serves in the port exactly as the
    converted state does."""
    from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
    from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer

    traj = _traj()
    pair = ModelPair("plate", traj, "xla")
    jts = JaxTrainer(pair.jmodel, pair.jconfig).init_train_state(jax.random.PRNGKey(0))
    path = jax_checkpoint.save(str(tmp_path), pair.jconfig, jts.replace(model=pair.jstate), 1)
    served = Predictor.from_config(pair.config, checkpoint=path, device="cpu")
    assert "world_edges" in dict(served.state.params.edge_encoders.items())
    assert "world_edge" in served.state.normalizers
    batch = {k: v[12:16] for k, v in traj.items()}
    want = Predictor(pair.config, state=pair.state, device="cpu").one_step(batch)
    assert np.array_equal(served.one_step(batch), want)
