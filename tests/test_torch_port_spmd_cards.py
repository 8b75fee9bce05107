"""The sharded train step over several devices in one process: a rank group
whose ranks lie on logical CPU devices (``torch.device("cpu", i)`` stands
for card i: the tensors lie on the one CPU, but the step keeps a parameter
copy for each device other than rank 0's and sums the copies' gradients in
device order), held against the JAX package's ``make_spmd_train_step`` on a
``make_mesh(2, 2)`` of the suite's virtual CPU devices and against the
port's one-device group.

The inputs are tests/test_torch_port_spmd.py's ``_setup()``: 4 frames of a
13x13 synthetic flag, latent 32, 2 blocks, float32, noise 0.003, gamma 0.9,
JAX's weights and noise draw.  The port runs ``agg_vjp: fused`` (K1 raw and
K2 per shard, or K7, their plain versions); the JAX step its ``gather``
path (one GSPMD program with replicated parameters: its gradient is the
global one, where its fused sharded backward divides by each shard's own
degree, tests/test_torch_port_spmd.py's standing finding).

Tolerances (each test states its own): loss rtol 1e-5; every gradient
within rtol 1e-4 and atol 1e-5 of its largest element
(``_assert_grads_close``); normalizer states rtol 1e-5; parameters after
one Adam step atol 1e-6 (tests/test_torch_port_multihost.py's against
JAX); copies, repeats and swapped states bit for bit.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.parallel import sharding as jax_sharding
from hyper_graph_nets_tpu.training.trainer import Trainer as JaxTrainer
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import make_sharded_forward, make_spmd_train_step, shard_topology
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from test_torch_port_spmd import (
    _assert_grads_close,
    _assert_normalizers_close,
    _config,
    _grads,
    _jax_loss_and_grads,
    _numpy_state,
    _port_state,
    _reset,
    _setup,
)

LAYOUTS = {"a_copy_per_rank": (0, 1, 2, 3), "two_ranks_a_copy": (0, 0, 1, 1)}
STEPS = 3


def _spread(shape, devices):
    return RankGroup(*shape, devices=[torch.device("cpu", d) for d in devices])


def _step(group, bands=None):
    s = _setup()
    return make_spmd_train_step(s["trainer"], shard_topology(s["topo"], group, overlap_bands=bands), group)


@functools.lru_cache(maxsize=None)
def _jax_spmd():
    """JAX's ``make_spmd_train_step`` on ``make_mesh(2, 2)`` (``gather``)
    from ``_setup()``'s state, key and frames: its loss, parameters (port
    names) and normalizers after one step, and the gradients of the step's
    own loss function (``sharding.py:258-275``) on the same mesh."""
    _reset()
    s = _setup()
    config = _config(agg_vjp="gather")
    jmodel = jax_get_model(config)
    mesh = jax_sharding.make_mesh(2, 2)
    jst = jax_sharding.shard_topology(jmodel.topology_from_trajectory(s["traj"]), mesh)
    step = jax_sharding.make_spmd_train_step(JaxTrainer(jmodel, config), jst, mesh)
    tstate = jax.tree.map(jnp.copy, s["jstate"])  # the step donates its state
    tstate, loss = step(tstate, jax_sharding.shard_frames(s["jframes"], mesh), jax.random.PRNGKey(1))
    params, _ = _numpy_state(tstate.model)
    gs = dict(s, jmodel=jmodel, jtopo=jst)
    gloss, grads, _ = _jax_loss_and_grads(gs, jax_sharding.spmd_gnn_config(jmodel, jst, mesh), jst, mesh)
    np.testing.assert_allclose(gloss, float(loss), rtol=1e-6)
    params = {n: p.detach() for n, p in state_from_jax_numpy(params, {}).params.named_parameters()}
    return float(loss), grads, params, tstate.model.normalizers


def _one_step(group, plant=False):
    """One step of the port's sharded step over ``group`` from ``_setup()``'s
    state: (loss, gradients, parameters after Adam, normalizers, the step);
    ``plant`` leaves out the sum over the devices (the planted control)."""
    s = _setup()
    step = _step(group)
    if plant:
        step._sum_over_devices = lambda params, per_device: None
    ts, loss = step(_port_state(s), s["frames"], normal=s["normal"])
    params = {n: p.detach().clone() for n, p in ts.model.params.named_parameters()}
    return float(loss), _grads(ts.model.params), params, ts.model.normalizers, step


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_over_several_devices_matches_jax_spmd_step(layout):
    """Over logical devices (0, 1, 2, 3) (a copy per rank) and (0, 0, 1, 1)
    (two ranks a copy): loss rtol 1e-5, the summed gradients within
    ``_assert_grads_close``'s limits (rtol 1e-4, atol 1e-5 x the largest
    element), normalizers rtol 1e-5, and the parameters after one Adam step
    atol 1e-6 against JAX's 2 x 2 step."""
    loss, grads, params, norms, step = _one_step(_spread((2, 2), LAYOUTS[layout]))
    assert list(step.copies) == [torch.device("cpu", d) for d in dict.fromkeys(LAYOUTS[layout]) if d]
    want_loss, want_grads, want_params, want_norms = _jax_spmd()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_close(grads, want_grads, layout)
    _assert_normalizers_close(norms, want_norms)
    for n, w in want_params.items():
        torch.testing.assert_close(params[n], w, rtol=0, atol=1e-6, msg=n)


def test_planted_control_without_the_device_sum_misses():
    """The step with the sum over the devices left out keeps the loss (rtol
    1e-5) and only rank 0's device's gradients, which miss the first
    test's gradient limits."""
    loss, grads, _, _, _ = _one_step(_spread((2, 2), LAYOUTS["a_copy_per_rank"]), plant=True)
    want_loss, want_grads, _, _ = _jax_spmd()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, want_grads, "no device sum")


def test_copies_stay_bit_for_bit_and_runs_repeat():
    """After three steps every device's copy equals the state's parameters
    bit for bit; two runs of three steps from one state give the same
    losses and parameters bit for bit; each copy's own gradient (before the
    sum) is non-zero somewhere and differs from the summed one wherever it
    is present."""
    s = _setup()
    runs = []
    for _ in range(2):
        step = _step(_spread((2, 2), LAYOUTS["a_copy_per_rank"]))
        ts, losses = _port_state(s), []
        for _ in range(STEPS):
            ts, loss = step(ts, s["frames"], normal=s["normal"])
            losses.append(loss)
        home = dict(ts.model.params.named_parameters())
        assert len(step.copies) == 3
        for d, kept in step.copies.items():
            some = False
            for n, p in kept.named_parameters():
                assert torch.equal(p, home[n]), (d, n)
                if p.grad is not None:
                    some = some or bool(p.grad.abs().max() > 0)
                    assert not torch.equal(p.grad, home[n].grad), (d, n)
            assert some, d
        runs.append((losses, {n: p.detach().clone() for n, p in home.items()}))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])


def _assert_step_close(got, want):
    """Loss rtol 1e-5, gradients ``_assert_grads_close``, normalizers rtol
    1e-5."""
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    _assert_grads_close(got[1], want[1], "spread vs one device")
    _assert_normalizers_close(got[2], want[2])


def test_step_over_several_devices_with_rmp_and_overlap_bands_matches_one_device():
    """Flag with RMP ``hyper`` (spectral, K = 4) on 2 x 2 over (0, 1, 2, 3),
    and flag with 1 x 4 overlap bands (K7's plain version) over (0, 1, 2,
    3), against the same group on one device: loss rtol 1e-5, gradients
    ``_assert_grads_close``, normalizers rtol 1e-5."""
    s = _setup()
    config = _config()
    config["params"]["model"]["rmp"] = {"clustering": "spectral", "connector": "hyper", "num_clusters": 4,
                                        "hyper_noise": 0.005, "frequency": 1}
    model = get_model(config)
    trainer = Trainer(model, config, device="cpu")
    topo = model.topology_from_trajectory(s["traj"], device="cpu")
    exp = build_expansion(model, config)
    static = exp.prepare(model, {k: v[0] for k, v in s["traj"].items()}, topo)
    start = trainer.init_train_state()

    def rmp_run(group):
        ts = trainer.init_train_state(state=start.model)
        step = make_spmd_train_step(trainer, shard_topology(topo, group), group, expansion=exp)
        loss, norms = step.loss_and_grads(ts, s["frames"], generator=torch.Generator().manual_seed(3), static=static)
        return loss, _grads(ts.model.params), norms

    _assert_step_close(rmp_run(_spread((2, 2), LAYOUTS["a_copy_per_rank"])), rmp_run(RankGroup(2, 2, device="cpu")))

    def overlap_run(group):
        ts = _port_state(s)
        loss, norms = _step(group, bands=4).loss_and_grads(ts, s["frames"], normal=s["normal"])
        return loss, _grads(ts.model.params), norms

    _assert_step_close(overlap_run(_spread((1, 4), (0, 1, 2, 3))), overlap_run(RankGroup(1, 4, device="cpu")))


def test_swapped_state_reaches_every_copy():
    """After a step on one state, a call on another state (a resumed
    checkpoint, a second trainer) gives what a new step gives on it, bit
    for bit, and leaves every copy equal to its parameters."""
    s = _setup()
    group = _spread((2, 2), LAYOUTS["two_ranks_a_copy"])
    used = _step(group)
    used(_port_state(s), s["frames"], normal=s["normal"])
    runs = []
    for step in (used, _step(group)):
        ts = s["trainer"].init_train_state()  # a seeded init, not _setup()'s state
        loss, _ = step.loss_and_grads(ts, s["frames"], normal=s["normal"])
        runs.append((loss, _grads(ts.model.params)))
        home = dict(ts.model.params.named_parameters())
        for n, p in step.copies[torch.device("cpu", 1)].named_parameters():
            assert torch.equal(p, home[n]), n
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_forward_over_several_devices_is_the_one_device_forward(layout):
    """The sharded forward over logical devices equals the one-device
    group's, bit for bit."""
    s = _setup()
    state = _port_state(s).model

    def fwd(group):
        return make_sharded_forward(s["model"], shard_topology(s["topo"], group), group)(state, s["frames"])

    assert torch.equal(fwd(_spread((2, 2), LAYOUTS[layout])), fwd(RankGroup(2, 2, device="cpu")))
