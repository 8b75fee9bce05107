"""Cylinder MeshGraphNets (cylinder_flow) in the port against the JAX package.

Inputs: the synthetic channel flow on a 7x5 grid (35 nodes, inflow, outflow,
walls and a wall obstacle), the same seeds on both sides;
``configs/cylinder.yaml`` cut to latent 16 and 2 blocks, float32
(``tests/torch_port_models.py``).  The JAX side runs its Pallas kernels in
interpret mode; the port, on the CPU, runs every kernel's plain version.

Tolerances:
- the generator and the TFRecords: byte for byte;
- one_step (velocity and pressure), rollout velocities and pressures and
  n-step losses: rtol 1e-5, atol 1e-6 of the field (float32, the same
  operations summed in another order); one_step against the same JAX path,
  the fused one through the JAX kernel in interpret mode; the fused path's
  rollout, n-step losses and gradients against JAX's ``gather`` path, which
  computes the same forward and, in float32 without ties, the same backward,
  to keep the interpret-mode compiles out of the file's time;
- loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 of each tensor's largest
  element; normalizer states rtol 1e-5 (tests/test_torch_port_train.py's).
"""
import numpy as np
import jax
import pytest
import torch

from hyper_graph_nets_tpu.data import synthetic as jax_synthetic
from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.models.cylinder import CylinderModel as JaxCylinderModel
from hyper_graph_nets_tpu_torch.data import loader, synthetic
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.models.cylinder import CylinderModel
from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training.task import get_task
from torch_port_models import ModelPair, assert_grads_close, assert_normalizers_close, cut_config

ROLLOUT_STEPS, N_STEP, N_TIMESTEPS = 4, 2, 5


def _traj(num_steps=10, nx=7, ny=5, seed=1):
    return add_targets(synthetic.cylinder_trajectory(num_steps=num_steps, nx=nx, ny=ny, seed=seed), "velocity", False)


def test_generator_and_loader_match_jax(tmp_path):
    """Byte for byte the JAX generator's arrays, and the TFRecords each
    package's loader writes and reads back."""
    for seed, (nx, ny) in ((0, (7, 5)), (2, (12, 8))):
        ours = synthetic.cylinder_trajectory(num_steps=9, nx=nx, ny=ny, seed=seed)
        theirs = jax_synthetic.cylinder_trajectory(num_steps=9, nx=nx, ny=ny, seed=seed)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k
    config = cut_config("cylinder")
    config["params"]["task"]["synthetic"] = {"trajectories": 2, "num_steps": 6, "nx": 7, "ny": 5}
    ours = list(loader.get_data(config, "test", data_dir=str(tmp_path / "port")))
    theirs = list(jax_get_data(config, "test", data_dir=str(tmp_path / "jax")))
    again = list(loader.get_data(config, "test", data_dir=str(tmp_path / "jax")))
    assert len(ours) == len(theirs) == len(again) == 1
    assert set(ours[0]) == {"cells", "mesh_pos", "node_type", "velocity", "pressure", "target|velocity"}
    for k in theirs[0]:
        np.testing.assert_array_equal(ours[0][k], theirs[0][k])
        np.testing.assert_array_equal(again[0][k], theirs[0][k])
    in_dir, _ = loader.get_directories("cylinder_flow", str(tmp_path / "port"))
    jin, _ = loader.get_directories("cylinder_flow", str(tmp_path / "jax"))
    assert open(f"{in_dir}/test.tfrecord", "rb").read() == open(f"{jin}/test.tfrecord", "rb").read()


def test_features_and_loss_rows_match_jax():
    """Node-type compaction, the node and mesh-edge features and the loss
    rows (NORMAL or OUTFLOW) of every frame, against the JAX package's."""
    traj = _traj()
    params = cut_config("cylinder")["params"]
    jm, pm = JaxCylinderModel(params), CylinderModel(params)
    topo = pm.build_topology(traj["cells"][0])
    frames = {k: torch.tensor(v) for k, v in traj.items() if k != "cells"}
    got = pm.frame_features(topo.senders, topo.receivers, frames)
    want = jax.vmap(lambda f: jm.frame_features(topo.senders.numpy(), topo.receivers.numpy(), f))(
        {k: np.asarray(v) for k, v in traj.items() if k != "cells"}
    )
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(pm.loss_mask(frames["node_type"]).numpy(),
                                  np.asarray(jm.loss_mask(traj["node_type"])))
    codes = np.unique(traj["node_type"])
    assert set(codes.tolist()) == {0, 4, 5, 6}
    np.testing.assert_array_equal(pm.compact_node_type(frames["node_type"]).numpy(),
                                  np.asarray(jm.compact_node_type(traj["node_type"])))


@pytest.mark.parametrize("agg_vjp", ["fused", "xla", "gather", "sorted"])
def test_one_step_rollout_and_n_step_match_jax(agg_vjp):
    """one_step (``Predictor``: velocity and pressure) on 6 frames, a 4-step
    rollout (velocities, the pressure carried, MSE) and the n-step losses,
    each path against the JAX package's; the fused path launches nothing on
    the CPU."""
    traj = _traj()
    pair = ModelPair("cylinder", traj, agg_vjp)
    assert (pair.topo.plan is not None) == (agg_vjp in ("fused", "sorted"))
    k1 = fused_edge_block.launches
    sl = slice(1, 7)
    jv, jp = pair.jax_one_step(sl)
    v, p = Predictor(pair.config, state=pair.state, device="cpu").one_step({k: x[sl] for k, x in traj.items()})
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-5, atol=1e-6)

    jmodel, jtopo = pair.jax_path("gather") if agg_vjp == "fused" else (pair.jmodel, pair.jtopo)
    jops, jmse = jmodel.rollout(pair.jstate, jtopo, traj, num_steps=ROLLOUT_STEPS)
    with torch.no_grad():
        ops, mse, carry = pair.model.rollout(pair.state, pair.topo, traj, num_steps=ROLLOUT_STEPS,
                                             return_carry=True)
    for k in ("pred_velocity", "pred_pressure"):
        np.testing.assert_allclose(ops[k].numpy(), np.asarray(jops[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=1e-9)
    assert torch.equal(carry[0], ops["pred_velocity"][-1]) and torch.equal(carry[1], ops["pred_pressure"][-1])
    # rows outside the loss mask keep their velocity
    keep = ~pair.model.loss_mask(torch.tensor(traj["node_type"][0])).numpy()
    np.testing.assert_array_equal(ops["pred_velocity"][:, keep].numpy(),
                                  np.broadcast_to(traj["velocity"][0][keep], (ROLLOUT_STEPS, keep.sum(), 2)))

    jm, jl = jmodel.n_step_computation(pair.jstate, jtopo, traj, n_step=N_STEP, num_timesteps=N_TIMESTEPS)
    with torch.no_grad():
        m, last = pair.model.n_step_computation(pair.state, pair.topo, traj, n_step=N_STEP,
                                                num_timesteps=N_TIMESTEPS)
    np.testing.assert_allclose([m, last], [float(jm), float(jl)], rtol=1e-5)
    assert fused_edge_block.launches == k1


@pytest.mark.parametrize("agg_vjp", ["fused", "xla"])
def test_loss_and_gradients_match_jax(agg_vjp):
    """One train step on 6 frames with JAX's noise: loss, gradients and
    normalizer states against the JAX package's; the validation step
    scores the velocity of the (velocity, pressure) update; no counters."""
    traj = _traj()
    pair = ModelPair("cylinder", traj, agg_vjp, jax_agg="gather" if agg_vjp == "fused" else None)
    sl = slice(1, 7)
    key = jax.random.PRNGKey(2)
    jloss, jgrads, jnorm = pair.jax_loss_and_grads(key, sl)
    trainer, ts, loss, metrics = pair.port_train_step(key, sl)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_normalizers_close(ts.model.normalizers, jnorm)
    assert_grads_close(ts.model.params, jgrads)
    assert metrics == {}

    from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer

    jval = JaxTrainer(pair.jmodel, pair.jconfig).make_validation_step(pair.jtopo)(pair.jstate, pair.jframes(sl))
    frames = trainer.frames({k: v[sl] for k, v in traj.items()})
    val = trainer.validation_step(pair.state, pair.topo, frames)
    np.testing.assert_allclose([float(x) for x in val], [float(x) for x in jval], rtol=1e-5)


def test_task_loop_runs(tmp_path):
    """``get_task(...).run_iterations()`` on a cut cylinder config (fused,
    one epoch of two trajectories, the evaluators, a checkpoint, the GIF),
    then ``get_scalars``: finite, and the rollouts hold velocities and
    pressures."""
    config = cut_config("cylinder")
    config["params"]["task"].update(
        batch_size=4, epochs=1, n_timesteps=6, trajectories=2,
        synthetic={"trajectories": 2, "num_steps": 8, "nx": 7, "ny": 5},
        test={"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": 2},
        validation={"trajectories": 1, "rollouts": 1, "n_viz": 1},
    )
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.run_iterations()
    scalars = task.get_scalars()
    assert scalars and all(np.isfinite(v) for v in scalars.values())
    rollout = task.simulator.rollout_evaluator(task.tstate, task._data("test"), n_rollouts=1, num_steps=4,
                                               logging=False, save=False)
    ops = rollout["rollouts"][0]
    assert ops["pred_velocity"].shape == (4, 35, 2) and ops["pred_pressure"].shape == (4, 35, 1)


def test_jax_checkpoint_serves_in_the_port(tmp_path):
    """A JAX cylinder checkpoint (``.pkl``: the 3-wide output normalizer of
    velocity and pressure) serves in the port exactly as the converted state
    does."""
    from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
    from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer

    traj = _traj()
    pair = ModelPair("cylinder", traj, "xla")
    jts = JaxTrainer(pair.jmodel, pair.jconfig).init_train_state(jax.random.PRNGKey(0))
    path = jax_checkpoint.save(str(tmp_path), pair.jconfig, jts.replace(model=pair.jstate), 1)
    served = Predictor.from_config(pair.config, checkpoint=path, device="cpu")
    assert served.state.normalizers["output"].acc_sum.shape == (3,)
    batch = {k: v[:4] for k, v in traj.items()}
    want = Predictor(pair.config, state=pair.state, device="cpu").one_step(batch)
    for a, b in zip(served.one_step(batch), want):
        assert np.array_equal(a, b)
