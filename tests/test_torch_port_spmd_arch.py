"""The sharded train step and forward on every other RMP architecture
(``repeated``, ``multiscale``, ``hetero``, ``multi``) and with the Ricci
balancer on cylinder and plate: the port on the CPU against its own
single-device step, and against the JAX package's for balanced cylinder
(the port's single-device steps of the other architectures are held
against JAX's in tests/test_torch_port_rmp.py).

The port's ranks run the kernels' plain versions (``RankGroup(...,
device="cpu")``).  Flag: 4 frames of a 10x10 synthetic flag, latent 32, 2
blocks, noise 0.003, gamma 0.9; RMP spectral into K = 4 clusters with hyper
noise 0.005 (``repeated``: no clustering, the flat block twice).  Cylinder
and plate: ``configs/cylinder.yaml`` and ``plate.yaml`` at latent 16 and 2
blocks (``tests/torch_port_models.py``) on tests/test_torch_port_spmd_models.py's
trajectories, with ``graph_balancer: ricci`` at 10 SDRF loops.  Without JAX,
a seeded init (its normalizers accumulated over the trajectory) and seeded
noise; with JAX, its init (normalizers accumulated over the trajectory)
and its field draw, its reference the ``xla`` path (no Pallas kernel; the
fused path differs by summation order only).

Tolerances (float32, tests/test_torch_port_spmd_expansion.py's, summation
order only: the sharded step sums the data ranks' partial statistics, the
ranks' aggregate partials and the ranks' gradients in rank order):
- loss rtol 1e-5; every gradient within rtol 1e-4 and atol 1e-5 of its
  largest element; normalizer states rtol 1e-5, atol 1e-5 of their largest;
- the sharded forward within rtol 1e-4 and atol 2e-5 of the single-device
  forward (the halo forward's);
- the planted controls must miss the loss limit: one graph rank's
  partials of ``multi``'s merged set (its only set, unfused) zeroed before
  they combine, and the balancer's keep mask laid out in the unsharded
  order on the round-robin layout (the JAX package's sharded balancer,
  ROADMAP section 3).  (On the card, chip_smoke.phase_spmd_arch plants the
  zeroed partials on every architecture.)
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.base import ModelState as JModelState
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.training.expansion import build_expansion as jax_build_expansion
from hyper_graph_nets_tpu.training.trainer import add_noise as jax_add_noise
from hyper_graph_nets_tpu.training.trainer import batched_forward as jax_batched_forward
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import fused_block as fb
from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.parallel.sharding import (
    ShardedStatic,
    make_sharded_forward,
    make_spmd_train_step,
    shard_static,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer
from torch_port_cases import flag_config
from torch_port_models import cut_config

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
SHAPES = {"2x2": ((2, 2), None), "1x4_overlap": ((1, 4), 4)}
NX, B, K = 10, 4, 4
STEP_KEY = 11
CHUNK = 16  # edges per chunk of the round-robin layout in the keep-mask control
RICCI = {"algorithm": "ricci", "remove_edges": True, "frequency": 1, "ricci": {"loops": 10, "tau": 150}}
# (rmp.clustering, rmp.connector) of each architecture
ARCHS = {"repeated": ("none", "repeated"), "multiscale": ("spectral", "multiscale"),
         "hetero": ("spectral", "hetero"), "multi": ("spectral", "multi")}


def _flag_config(arch, agg_vjp="fused", **model):
    clustering, connector = ARCHS[arch]
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4, **model)
    config["params"]["model"]["rmp"] = {"clustering": clustering, "connector": connector, "num_clusters": K,
                                        "hyper_noise": 0.005, "frequency": 1}
    return config


@functools.lru_cache(maxsize=None)
def _flag_traj():
    return jax_add_targets(jax_flag_trajectory(num_steps=B + 2, nx=NX, ny=NX), "world_pos", True)


@functools.lru_cache(maxsize=None)
def _model_traj(family):
    from test_torch_port_spmd_models import _traj

    return _traj(family)


class Case:
    """The port's model, trainer, topology, prepared static, frames and
    noise draws on one configuration; the state (a seeded init, or
    ``state``) made anew for each step."""

    def __init__(self, config, traj, frames, state=None, normal=None, hyper=None):
        self.model = get_model(config)
        self.trainer = Trainer(self.model, config, device="cpu")
        self.topo = self.model.topology_from_trajectory(traj, device="cpu")
        exp = self.trainer.expansion
        self.static = None if exp is None else exp.prepare(self.model, {k: v[0] for k, v in traj.items()}, self.topo)
        self.frames = self.trainer.frames({k: np.asarray(v[frames]) for k, v in traj.items()})
        if state is None:  # a seeded init whose normalizers have seen the trajectory
            every = self.trainer.frames({k: np.asarray(v) for k, v in traj.items()})
            with torch.no_grad():
                state = self.model.init_state()
                graph, _, state = self.model.make_graph(state, self.topo, every, True)
                if exp is not None:
                    _, state = exp.expand(state, graph, every, self.model, is_training=True, static=self.static,
                                          generator=torch.Generator().manual_seed(3))
                state = self.model.get_target(state, every, is_training=True)[1]
        self._state = state
        x = self.frames[self.model.field]
        g = torch.Generator().manual_seed(STEP_KEY)
        self.normal = torch.randn(x.shape, generator=g) if normal is None else normal
        shape = None if exp is None else exp.hyper_noise_shape(self.model, self.frames, self.static)
        self.hyper = hyper if hyper is not None or shape is None else torch.randn(shape, generator=g)

    def state(self):
        return self.trainer.init_train_state(state=self._state)

    def single(self):
        ts = self.state()
        loss, norms = self.trainer.loss_and_grads(ts, self.topo, self.frames, normal=self.normal, static=self.static,
                                                  hyper_normal=self.hyper)
        return float(loss), _grads(ts.model.params), norms

    def sharded(self, shape="2x2", plant=None, chunk=None):
        (D, G), bands = SHAPES[shape]
        group = RankGroup(D, G, device="cpu")
        stopo = shard_topology(self.topo, group, overlap_bands=bands, **({"chunk": chunk} if chunk else {}))
        step = make_spmd_train_step(self.trainer, stopo, group)
        static = self.static
        if plant is not None:
            static = plant(shard_static(self.trainer.expansion, static, stopo, group))
        ts = self.state()
        loss, norms = step.loss_and_grads(ts, self.frames, normal=self.normal, static=static, hyper_normal=self.hyper)
        return float(loss), _grads(ts.model.params), norms


def _grads(params):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone()) for n, p in params.named_parameters()}


@functools.lru_cache(maxsize=None)
def _flag_case(arch):
    return Case(_flag_config(arch), _flag_traj(), slice(0, B))


@functools.lru_cache(maxsize=None)
def _model_case(family):
    model = {"graph_balancer": RICCI}
    if family == "plate":
        model["max_world_edges"] = 64
    return Case(cut_config(family, "fused", **model), _model_traj(family), slice(2, 2 + B))


@functools.lru_cache(maxsize=None)
def _single(case):
    return case.single()


def _assert_grads_close(got, want, what):
    for name, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-5 * scale, msg=f"{what}: {name}")


def _assert_normalizers_close(got, want):
    for name, ns in want.items():
        for f in NORMALIZER_FIELDS:
            w = np.asarray(getattr(ns, f))
            np.testing.assert_allclose(getattr(got[name], f).numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}.{f}")


def _assert_matches(result, want, what):
    loss, grads, norms = result
    want_loss, want_grads, want_norms = want
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=what)
    _assert_grads_close(grads, want_grads, what)
    _assert_normalizers_close(norms, want_norms)


def _zeroed_partials(real):
    """The planted control: graph rank 1's aggregate partials zeroed before
    they combine, on every set that combines partials."""

    def combine(group, raws, F):
        raws = [torch.zeros_like(x) if group.axis_index(r, "graph") == 1 else x for r, x in enumerate(raws)]
        return real(group, raws, F)

    return combine


# -- the architectures ---------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_arch_step_matches_single_device(arch):
    """``repeated`` (no expansion: the flat block twice), ``multiscale``
    (three cross rounds, a second mesh sub-step), ``hetero`` (flat blocks
    over the mesh and tier sets, the hyper rows' own node model) and
    ``multi`` (the merged mesh_edges, unfused, cut into contiguous slices
    with per-rank sums) on 2 x 2 against the port's single-device step."""
    case = _flag_case(arch)
    assert case.model.gnn_config.architecture == arch
    _assert_matches(case.sharded(), _single(case), arch)


def test_zeroed_partials_of_the_merged_set_miss(monkeypatch):
    """The planted control on ``multi``: graph rank 1's partials of the
    merged mesh_edges set (its only set, unfused) zeroed before they
    combine; the loss must miss its limit."""
    case = _flag_case("multi")
    monkeypatch.setattr(segment_ops, "combine_partials", _zeroed_partials(segment_ops.combine_partials))
    loss, _, _ = case.sharded()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(loss, _single(case)[0], rtol=1e-5)


def test_multi_merged_set_is_laid_out_with_its_mask_and_sums():
    """``multi``'s merged set on 2 x 2: each rank's slice of the laid-out
    mesh, inter, up and down sets one after another, its mask with its
    edges (the padding of every part masked), its fixed-order sums built on
    the slice."""
    case = _flag_case("multi")
    group = RankGroup(2, 2, device="cpu")
    stopo = shard_topology(case.topo, group)
    st = shard_static(case.trainer.expansion, case.static, stopo, group).members[0]
    parts = [(stopo.senders, stopo.receivers, stopo.mask)] + [
        (getattr(st, f"{p}_senders"), getattr(st, f"{p}_receivers"), getattr(st, f"{p}_mask"))
        for p in ("inter", "up", "down")]
    snd, rcv, mask = (torch.cat([torch.as_tensor(p[i]) for p in parts]) for i in range(3))
    per = len(snd) // 2
    valid = [float(torch.as_tensor(p[2]).sum()) for p in parts]
    assert float(mask.sum()) == sum(valid)
    assert valid[0] == len(case.topo.senders) and valid[2] == valid[3] > 0
    data = torch.randn(per, 3, generator=torch.Generator().manual_seed(0))
    for r in range(group.n):
        k = group.axis_index(r, "graph")
        got = segment_ops.segment_sum_fixed(data, st.merged_sums.sums[r].receivers)
        want = torch.zeros(got.shape).index_add_(0, rcv[k * per:(k + 1) * per].long(), data)
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_arch_forward_matches_single_device(arch):
    case = _flag_case(arch)
    group = RankGroup(2, 2, device="cpu")
    fwd = make_sharded_forward(case.model, shard_topology(case.topo, group), group, expansion=case.trainer.expansion)
    state = case.state().model
    got = fwd(state, case.frames, static=case.static)
    with torch.no_grad():
        graph, _, _ = case.model.make_graph(state, case.topo, case.frames, False)
        if case.trainer.expansion is not None:
            graph, _ = case.trainer.expansion.expand(state, graph, case.frames, case.model, is_training=False,
                                                     static=case.static)
        single = case.model.forward(state, graph)
    assert got.shape == (B, NX * NX, 3)
    torch.testing.assert_close(got, single, rtol=1e-4, atol=2e-5)


def test_sharded_step_ignores_fused_fwd_xla():
    """The sharded step takes the edge-sharded fused path whatever
    ``fused_fwd`` says, as the JAX package's (its ``spmd_mesh`` branch comes
    first): with ``fused_fwd: xla`` no hybrid runs and the step is the
    ``kernel`` step's, bit for bit."""
    calls, real = [], fb.fused_edge_block_hybrid

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    results = []
    for fused_fwd in ("kernel", "xla"):
        config = flag_config(None)
        config["params"]["model"].update(noise=0.003, gamma=0.9, fused_fwd=fused_fwd)
        case = Case(config, _flag_traj(), slice(0, B))
        fb.fused_edge_block_hybrid = spy
        try:
            results.append(case.sharded())
        finally:
            fb.fused_edge_block_hybrid = real
    assert not calls
    assert results[0][0] == results[1][0]
    for name, g in results[0][1].items():
        assert torch.equal(g, results[1][1][name]), name


# -- against the JAX package ---------------------------------------------------------


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
                   for name, ns in state.normalizers.items()}
    return params, normalizers


def _jax_reference(jconfig, traj, frames):
    """JAX's single-device step of an expansion without RMP: its state
    (normalizers accumulated over the trajectory), loss, gradients (port
    layout), normalizers and field noise draw at ``STEP_KEY``."""
    model = jax_get_model(jconfig)
    topo = model.topology_from_trajectory(traj)
    exp = jax_build_expansion(model, jconfig)
    static = exp.prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    every = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}

    def accumulated(state):
        graph, _, state = model.make_graph(state, topo, every, True)
        _, state = exp.expand(state, graph, every, model, True, key=jax.random.PRNGKey(3), static=static)
        return model.get_target(state, every, True)[1]

    state = jax.jit(lambda key: accumulated(model.init_state(key)))(jax.random.PRNGKey(0))
    _, nkey, ekey = jax.random.split(jax.random.PRNGKey(STEP_KEY), 3)
    clean = {k: jnp.asarray(v[frames]) for k, v in traj.items() if k != "cells"}

    def loss_fn(params, normalizers):
        jframes = jax_add_noise(clean, model.field, model.noise_scale, model.noise_gamma, nkey)
        mstate = JModelState(params=params, normalizers=normalizers)
        g, _, mstate = model.make_graph(mstate, topo, jframes, True)
        g, mstate = exp.expand(mstate, g, jframes, model, is_training=True, key=ekey, static=static)
        target, mstate = model.get_target(mstate, jframes, is_training=True)
        out = jax_batched_forward(model, mstate.params, g)
        mask = model.loss_mask(jframes["node_type"]).astype(out.dtype)[..., None]
        return jnp.sum(jnp.square(target - out) * mask) / (jnp.sum(mask) * out.shape[-1]), mstate.normalizers

    (loss, norms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params, state.normalizers)
    grads = {n: g.detach() for n, g in state_from_jax_numpy(jax.tree.map(np.asarray, grads), {}).params.named_parameters()}
    normal = torch.from_numpy(np.array(jax.random.normal(nkey, clean[model.field].shape, jnp.float32)))
    return dict(state=state_from_jax_numpy(*_numpy_state(state)), loss=float(loss), grads=grads, norms=norms,
                normal=normal)


def test_sharded_balancer_step_on_cylinder_matches_jax():
    """The balancer on cylinder (JAX's ``xla`` path, no Pallas kernel): the
    sharded step on 2 x 2 against JAX's single-device step, same state and
    noise, and against the port's.  (The other architectures' single-device
    steps are held against JAX's in tests/test_torch_port_rmp.py,
    ``test_loss_and_grads_equal_jax``.)"""
    traj, frames = _model_traj("cylinder"), slice(2, 2 + B)
    j = _jax_reference(cut_config("cylinder", "xla", graph_balancer=RICCI), traj, frames)
    case = Case(cut_config("cylinder", "fused", graph_balancer=RICCI), traj, frames, state=j["state"],
                normal=j["normal"])
    got = case.sharded()
    _assert_matches(got, (j["loss"], j["grads"], j["norms"]), "jax")
    _assert_matches(got, case.single(), "port")


# -- the balancer on cylinder and plate ----------------------------------------------------


@pytest.mark.parametrize("family", ["cylinder", "plate"])
def test_sharded_balancer_step_on_cylinder_and_plate_matches_single_device(family):
    """``graph_balancer: ricci`` on cylinder and plate (beside plate's
    per-frame world set, which is cut per frame) on 2 x 2: the balance set
    padded to a multiple of ``graph``, the keep mask laid out as the mesh
    edges lie."""
    case = _model_case(family)
    assert case.static[0].bal_mask.sum() > 0
    _assert_matches(case.sharded(), _single(case), family)


def _unsharded_keep(sstatic: ShardedStatic) -> ShardedStatic:
    """The planted control: the balancer's keep mask in the unsharded edge
    order, padded at the end (the JAX package's ``GraphBalancer.expand``
    under its sharded step)."""
    bal = sstatic.members[0]
    unsharded = torch.empty_like(bal.mesh_keep)
    unsharded[torch.from_numpy(sstatic.topo.layout.perm)] = bal.mesh_keep  # laid[i] = padded[perm[i]]
    return ShardedStatic(topo=sstatic.topo, members=(bal._replace(mesh_keep=unsharded),) + sstatic.members[1:])


def test_sharded_balancer_on_the_round_robin_layout_and_its_unsharded_keep_control():
    """Cylinder with the balancer on 1 x 4 with overlap bands (the
    round-robin layout, K7's, in chunks of ``CHUNK`` edges: the default 256
    would leave every edge of the 7x5 grid in the first chunk, where the two
    orders agree): the step matches the single-device one, and
    the same step with the keep mask in the unsharded order masks other
    edges than the balancer removed and must miss."""
    case = _model_case("cylinder")
    assert float((case.static[0].mesh_keep == 0).sum()) > 0
    want = _single(case)
    _assert_matches(case.sharded("1x4_overlap", chunk=CHUNK), want, "1x4_overlap")
    loss, _, _ = case.sharded("1x4_overlap", plant=_unsharded_keep, chunk=CHUNK)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(loss, want[0], rtol=1e-5)
