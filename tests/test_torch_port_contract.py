"""The port's contract: what it imports, where it runs, what it refuses,
and its host-side pieces against the JAX package's.

- The port imports neither ``jax``, ``sklearn`` nor ``hyper_graph_nets_tpu``
  (checked in a fresh interpreter and by a scan of the sources).
- Entry points default to the card and raise without one; CPU runs never
  launch the kernel.
- Configurations of later slices (and an unknown balancer) raise
  ``NotImplementedError``, a missing checkpoint ``FileNotFoundError``; the
  Ricci balancer serves on the CPU.
- Mesh edges, synthetic data, config parsing, the normalizer and the
  segment ops agree with the JAX package (float32: rtol = 1e-6, atol = 1e-6).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.core import normalizer as jax_norm
from hyper_graph_nets_tpu.core import segment_ops as jax_segment_ops
from hyper_graph_nets_tpu.core.mesh import cells_to_edges as jax_cells_to_edges
from hyper_graph_nets_tpu.core.mesh import mesh_fingerprint as jax_mesh_fingerprint
from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.utils.config import read_yaml as jax_read_yaml
from hyper_graph_nets_tpu_torch.core import normalizer as norm
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges, mesh_fingerprint
from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
from hyper_graph_nets_tpu_torch.nn.mlp import MLP
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    fused_edge_block,
    fused_edge_block_bwd,
    fused_edge_block_bwd_stream,
)
from hyper_graph_nets_tpu_torch.ops.segment_pna import pna_sorted, pna_sorted_bwd
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.utils.config import read_yaml
from torch_port_cases import flag_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyper_graph_nets_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn", "hyper_graph_nets_tpu")


# -- (d) imports ------------------------------------------------------------


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import hyper_graph_nets_tpu_torch, hyper_graph_nets_tpu_torch.serving\n"
        "import hyper_graph_nets_tpu_torch.convert, chip_smoke\n"
        "import hyper_graph_nets_tpu_torch.balancer.ricci, hyper_graph_nets_tpu_torch.balancer.base\n"
        "import hyper_graph_nets_tpu_torch.ops.maxprod, hyper_graph_nets_tpu_torch.training.trainer\n"
        "import hyper_graph_nets_tpu_torch.ops.ring, hyper_graph_nets_tpu_torch.ops.fused_overlap\n"
        "import hyper_graph_nets_tpu_torch.parallel.group, hyper_graph_nets_tpu_torch.parallel.sharding\n"
        "import hyper_graph_nets_tpu_torch.parallel.halo\n"
        "import hyper_graph_nets_tpu_torch.rmp.remote_message_passing, hyper_graph_nets_tpu_torch.rmp.connector\n"
        "import hyper_graph_nets_tpu_torch.rmp.clustering, hyper_graph_nets_tpu_torch.rmp.sk_numpy\n"
        "import hyper_graph_nets_tpu_torch.rmp.hdbscan_tree, hyper_graph_nets_tpu_torch.parallel.multihost\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_name_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    names = {os.path.relpath(f, PORT) for f in files}
    assert {"parallel/halo.py", "parallel/group.py", "ops/ring.py", "ops/fused_overlap.py",
            "parallel/multihost.py", "rmp/sk_numpy.py", "rmp/hdbscan_tree.py"} <= names
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


# -- (e) device and launches ------------------------------------------------


def test_predictor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(flag_config("bfloat16"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_config(flag_config("bfloat16"))


def test_cpu_predictor_never_launches_the_kernel():
    before = fused_edge_block.launches
    traj = add_targets(flag_trajectory(num_steps=4, nx=6, ny=6), "world_pos", True)
    p = Predictor(flag_config("bfloat16"), device="cpu")
    out = p.one_step(traj)
    r = p.rollout(traj, num_steps=2)
    assert out.shape == (2, 36, 3) and np.isfinite(out).all()
    assert r["pred_pos"].shape == (2, 36, 3) and np.isfinite(r["mse"]).all()
    assert fused_edge_block.launches == before


def test_full_scale_config_loads_as_shipped():
    """configs/flag_full_scale.yaml with RMP on: spectral clustering into 16
    clusters, the hierarchical ``hyper`` blocks, the three cluster-tier edge
    sets and the hyper tier's encoder input (node features + 3)."""
    p = Predictor(read_yaml("flag_full_scale"), device="cpu")
    cfg = p.model.gnn_config
    assert (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp) == (128, 15, "fused")
    assert cfg.architecture == "hyper" and cfg.hyper_in_dim == 8
    assert cfg.edge_sets == (
        "mesh_edges", "intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster"
    )
    rmp = p.expansion.members[0]
    assert type(rmp._clustering).__name__ == "SpectralClustering" and rmp._clustering.num_clusters == 16


def test_rmp_fused_tiers_raises_naming_the_roadmap():
    """``rmp.fused_tiers: true`` with ``agg_vjp: fused`` serves: ``prepare``
    gives the up, down and inter sets K1/K2 plans over their valid
    prefixes.  With the hybrid forward ``fused_fwd: xla`` (ROADMAP section
    2's first row, which raised until it was ported) it serves as well."""
    config = _with(agg_vjp="fused", rmp={"clustering": "spectral", "connector": "hyper", "num_clusters": 4,
                                         "fused_tiers": True})
    p = Predictor(config, device="cpu")
    traj = add_targets(flag_trajectory(num_steps=4, nx=6, ny=6), "world_pos", True)
    assert np.isfinite(p.one_step(traj)).all()
    (static,) = p.expansion.static
    assert all(plan is not None for plan in (static.up_plan, static.down_plan, static.inter_plan))
    config["params"]["model"]["fused_fwd"] = "xla"
    assert np.isfinite(Predictor(config, device="cpu").one_step(traj)).all()


def test_full_scale_config_loads_with_rmp_off():
    config = read_yaml("flag_full_scale")
    config["params"]["model"]["rmp"].update(clustering="none", connector="none")
    cfg = Predictor(config, device="cpu").model.gnn_config
    assert (cfg.latent_size, cfg.message_passing_steps, cfg.agg_vjp) == (128, 15, "fused")
    assert cfg.cd == torch.bfloat16 and cfg.architecture == "none"


# -- (f) later slices raise -------------------------------------------------


def _with(**model):
    config = flag_config("bfloat16")
    config["params"]["model"].update(model)
    return config


@pytest.mark.parametrize(
    "config",
    [
        _with(rmp={"clustering": "optics", "connector": "hyper"}),  # no such clustering
        _with(graph_balancer={"algorithm": "forman"}),  # no such balancer
        # k-medoids, which neither package has (k-means, the mixture and
        # HDBSCAN run: tests/test_torch_port_cluster.py)
        _with(rmp={"clustering": "kmedoids", "connector": "hyper"}),
    ],
    ids=["rmp", "balancer", "kmeans"],
)
def test_later_slices_raise(config):
    with pytest.raises(NotImplementedError):
        Predictor(config, device="cpu")


def test_fused_fwd_xla_on_the_fused_path_raises():
    """``fused_fwd: xla`` on the fused path selects the JAX package's hybrid
    (an unfused forward, then K2 with a tie tolerance).  It raised until the
    hybrid was ported; now the same config builds, and its one-step forward
    sends the mesh set through ``ops.fused_block.fused_edge_block_hybrid``
    (tests/test_torch_port_hybrid.py holds it against JAX)."""
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb

    config = _with(agg_vjp="fused", fused_fwd="xla")
    p = Predictor(config, device="cpu")
    assert p.model.gnn_config.fused_fwd == "xla" and p.model.gnn_config.agg_vjp == "fused"
    traj = add_targets(flag_trajectory(num_steps=3, nx=4, ny=4), "world_pos", True)
    calls, real = [], fb.fused_edge_block_hybrid

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    fb.fused_edge_block_hybrid = spy
    try:
        out = p.one_step(traj)
    finally:
        fb.fused_edge_block_hybrid = real
    assert len(calls) == p.model.message_passing_steps
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize(
    "agg_vjp, fused_fwd",
    [("fused", "kernel"), ("gather", "xla"), ("sorted", "xla"), ("fused", None)],
    ids=["fused-kernel", "gather-xla", "sorted-xla", "fused-unset"],
)
def test_fused_fwd_other_cases_build_as_before(agg_vjp, fused_fwd):
    """Every other case builds: the JAX package takes the hybrid only on the
    fused path, and the key defaults to 'kernel'."""
    model = {"agg_vjp": agg_vjp} if fused_fwd is None else {"agg_vjp": agg_vjp, "fused_fwd": fused_fwd}
    traj = add_targets(flag_trajectory(num_steps=3, nx=4, ny=4), "world_pos", True)
    p = Predictor(_with(**model), device="cpu")
    assert p.model.gnn_config.agg_vjp == agg_vjp
    assert p.model.gnn_config.fused_fwd == (fused_fwd or "kernel")
    assert np.isfinite(p.one_step(traj)).all()


def test_cpu_predictor_serves_the_ricci_balancer_without_launching():
    """A ``graph_balancer: ricci`` config builds, runs SDRF in ``prepare``
    (on each call, as the JAX package's Predictor does) and serves on the
    CPU; K5's counter does not move."""
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod

    before = (fused_edge_block.launches, maxprod.launches)
    traj = add_targets(flag_trajectory(num_steps=4, nx=6, ny=6), "world_pos", True)
    p = Predictor(
        _with(graph_balancer={"algorithm": "ricci", "remove_edges": True, "ricci": {"loops": 4, "tau": 150}}),
        device="cpu",
    )
    assert p.model.gnn_config.edge_sets == ("mesh_edges", "balance")
    out = p.one_step(traj)
    r = p.rollout(traj, num_steps=2)
    static = p.expansion.static[0]
    assert int(static.bal_mask.sum()) >= 2 and static.bal_mask.shape == (8,)
    assert out.shape == (2, 36, 3) and np.isfinite(out).all()
    assert r["pred_pos"].shape == (2, 36, 3) and np.isfinite(r["mse"]).all()
    assert (fused_edge_block.launches, maxprod.launches) == before


def test_cpu_predictor_sorted_serves_without_launching():
    """``agg_vjp: sorted`` builds and serves on the CPU (the sorted pna's
    plain versions); no kernel counter moves."""
    counts = lambda: (
        fused_edge_block.launches, fused_edge_block_bwd.launches,
        fused_edge_block_bwd_stream.launches, pna_sorted.launches, pna_sorted_bwd.launches,
    )
    before = counts()
    traj = add_targets(flag_trajectory(num_steps=4, nx=6, ny=6), "world_pos", True)
    p = Predictor(_with(agg_vjp="sorted"), device="cpu")
    assert p.model.gnn_config.agg_vjp == "sorted"
    out = p.one_step(traj)
    r = p.rollout(traj, num_steps=2)
    assert out.shape == (2, 36, 3) and np.isfinite(out).all()
    assert r["pred_pos"].shape == (2, 36, 3) and np.isfinite(r["mse"]).all()
    assert counts() == before


def test_checkpoint_and_other_datasets_raise():
    """A checkpoint path that holds nothing raises (loading one is
    tests/test_torch_port_task.py's), and so does a dataset the port has no
    model for; cylinder_flow and deforming_plate build theirs
    (tests/test_torch_port_cylinder.py and test_torch_port_plate.py hold
    them against the JAX package)."""
    with pytest.raises(FileNotFoundError):
        Predictor.from_config(flag_config("bfloat16"), checkpoint="somewhere", device="cpu")
    config = flag_config("bfloat16")
    config["params"]["task"]["dataset"] = "airfoil"
    with pytest.raises(NotImplementedError, match="unknown dataset"):
        Predictor(config, device="cpu")
    for name, model_type in (("cylinder", "cylinder"), ("plate", "plate")):
        assert Predictor(read_yaml(name), device="cpu").model.model_type == model_type


def _train_spread():
    import importlib.util

    path = os.path.join(REPO, "tools", "torch_port", "train_spread.py")
    spec = importlib.util.spec_from_file_location("train_spread", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_check_holds_the_scatter_order_fixed(monkeypatch):
    """``chip_smoke.fixed_scatter_order`` turns PyTorch's deterministic
    algorithms on for its block only.  ``tools/torch_port/train_spread.py``
    (the train-step check repeated), with the CPU on both sides at 8x8, 2
    blocks, latent 16, float32 with the balancer: each run goes through the
    order it names (the reference and the fixed runs with deterministic
    algorithms on, the others with them off); in a fixed order every run
    reads exactly 0 (the same operations in the same order); as they come,
    every run stays within ``TRAIN_TOL``.  On the CPU the runs as they come
    read 0 as well, at 1, 4 and 8 threads alike (PyTorch's CPU scatters keep
    their order), so the orders' readings part only on the card
    (``phase_train``); the spread runs on one thread."""
    spread = _train_spread()
    cs = spread.cs
    assert not torch.are_deterministic_algorithms_enabled()
    with cs.fixed_scatter_order():
        assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer

    orders, loss_and_grads = [], Trainer.loss_and_grads

    def recorded(self, *args, **kwargs):
        orders.append(torch.are_deterministic_algorithms_enabled())
        return loss_and_grads(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "loss_and_grads", recorded)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small operations on busy cores: see test_torch_port_task._one_cpu_thread
    try:
        res = spread.spread(seconds=60, fixed_seconds=60, device="cpu", nx=8,
                            model=dict(message_passing_steps=2, latent_size=16), max_runs=2)
    finally:
        torch.set_num_threads(threads)
    assert not torch.are_deterministic_algorithms_enabled()
    assert res["fixed"]["runs"] == res["atomic"]["runs"] == 2
    assert orders == [True, False, False, True, True]  # the reference, 2 as they come, 2 in a fixed order
    assert dict(res["fixed"]["worst"]) == {"0": 2} and dict(res["fixed"]["loss"]) == {"0": 2}
    assert all(float(w) <= cs.TRAIN_TOL["float32"][1] for w in res["atomic"]["worst"])
    assert any(".balance." in name for name in res["names"])


# -- host-side pieces against the JAX package ---------------------------------


@pytest.mark.parametrize("shape", [(4, 5), (10, 10)])
def test_mesh_edges_and_fingerprint_match_jax(shape):
    traj = flag_trajectory(num_steps=3, nx=shape[0], ny=shape[1])
    cells = traj["cells"][0]
    ours, theirs = cells_to_edges(cells), jax_cells_to_edges(cells)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert np.all(np.diff(ours.receivers) >= 0)
    assert mesh_fingerprint(cells, 7) == jax_mesh_fingerprint(cells, 7)


def test_synthetic_flag_and_targets_match_jax():
    ours = add_targets(flag_trajectory(num_steps=6, nx=5, ny=4, seed=3), "world_pos", True)
    theirs = jax_add_targets(jax_flag_trajectory(num_steps=6, nx=5, ny=4, seed=3), "world_pos", True)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("name", ["flag_full_scale", "flag_fused_demo", "minimal", "plateCluster", "cylinder", "plate"])
def test_read_yaml_matches_jax(name):
    assert read_yaml(name) == jax_read_yaml(name)


def test_normalizer_matches_jax_and_returns_new_state():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(3, 20, 4)).astype(np.float32) * 3 + 1
    mask = (rng.random((3, 20)) > 0.3).astype(np.float32)
    js = jax_norm.accumulate(jax_norm.init(4), jnp.asarray(data), jnp.asarray(mask))
    jout, js = jax_norm.normalize(js, jnp.asarray(data), accumulate_stats=True)
    s0 = norm.init(4)
    s1 = norm.accumulate(s0, torch.tensor(data), torch.tensor(mask))
    out, s2 = norm.normalize(s1, torch.tensor(data), accumulate_stats=True)
    assert float(s0.acc_count) == 0.0 and float(s1.num_accumulations) == 1.0
    for f in ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared"):
        np.testing.assert_allclose(getattr(s2, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    back = norm.inverse(s2, out)
    np.testing.assert_allclose(back.numpy(), data, rtol=1e-5, atol=1e-5)
    capped = norm.accumulate(
        norm.init(4, max_accumulations=1), torch.tensor(data)
    )
    assert float(norm.accumulate(capped, torch.tensor(data)).acc_count) == 60.0


@pytest.mark.parametrize("batched", [False, True])
def test_segment_pna_matches_jax(batched):
    rng = np.random.default_rng(6)
    N, E, F = 9, 30, 5
    ids = np.sort(rng.integers(0, N - 2, size=E)).astype(np.int32)  # last 2 empty
    data = rng.normal(size=((2, E, F) if batched else (E, F))).astype(np.float32)
    data[..., 3, :] = data[..., 4, :]  # ties
    mask = (rng.random(E) > 0.2).astype(np.float32)

    def jax_aggregate(op):  # the JAX package vmaps its segment ops over a batch
        one = lambda d: np.asarray(
            jax_segment_ops.aggregate(jnp.asarray(d), jnp.asarray(ids), N, op, jnp.asarray(mask))
        )
        return np.stack([one(d) for d in data]) if batched else one(data)

    got = segment_ops.aggregate(torch.tensor(data), torch.tensor(ids), N, "pna", torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), jax_aggregate("pna"), rtol=1e-6, atol=1e-6)
    assert torch.all(got[..., N - 2 :, :] == 0)
    for op in ("sum", "mean", "max", "min"):
        g = segment_ops.aggregate(torch.tensor(data), torch.tensor(ids), N, op, torch.tensor(mask))
        np.testing.assert_allclose(g.numpy(), jax_aggregate(op), rtol=1e-6, atol=1e-6)


def test_mlp_init_distribution_and_generator():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = MLP.init(g1, 40, (16, 16, 3), layer_norm=False)
    b = MLP.init(g2, 40, (16, 16, 3), layer_norm=False)
    for wa, wb in zip(a.weights, b.weights):
        assert torch.equal(wa, wb)
    assert a.weights[0].shape == (16, 40)
    assert a.weights[0].abs().max() <= 1 / np.sqrt(40)
    assert a.biases[1].abs().max() <= 1 / np.sqrt(16)
    assert not a.layer_norm and MLP.init(g1, 4, (8,)).layer_norm
