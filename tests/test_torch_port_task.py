"""The port's task loop against the JAX package's: ``MeshSimulator`` (fit and
the one-step, rollout and n-step evaluators), checkpoints of both packages,
``MeshTask`` resume, the CLI and ``Predictor.from_config(checkpoint=...)``.

Data: the synthetic flag_minimal dataset (8x8 flag, 12 frames, so 10
training frames a trajectory) that the JAX loader writes under a
``tmp_path`` directory; 2 message-passing blocks, latent 32, float32,
``agg_vjp: fused`` (the JAX side runs its Pallas kernels in interpret mode,
the port on the CPU runs the kernels' plain versions), batch 4, so a
trajectory's batches hold 4, 4 and 2 frames.  The port starts from the JAX
simulator's initial state (weights, normalizers and Adam state through
``convert.train_state_from_jax_numpy``), and its training noise is JAX's
draw: the test repeats the JAX simulator's key split (``simulator.py:282``)
and the train step's (``trainer.py:159-163``) and puts the draw in place of
``MeshSimulator._normal``.

Tolerances (float32, as tests/test_torch_port_train.py and
test_torch_port_model.py): losses and evaluator scalars rtol = 1e-5 (the
same operations, summed in another order); parameters after an epoch or
after one Adam step atol = 1e-6; normalizer states rtol = 1e-5 and atol = 1e-5 of the field's largest
magnitude (sums that cancel to about 0); rollout
positions rtol = 1e-5, atol = 1e-6.  One exception, after the epoch: an
element whose gradient at the first Adam step lies within 10 eps (1e-7) of
0.  There the step is ``lr * g / (|g| + eps)``, which turns a float32
summation-order difference in ``g`` into a difference of a few hundredths
of lr (measured: 51 elements of 32,227 with such a gradient, one of them,
gradient -3.25e-8, off by 2.1e-6 = 0.021 lr); such elements are held to
0.1 lr.  The checkpoint round trip and the served state are bit
for bit.
"""
import contextlib
import os
import pickletools
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.training import checkpoint as jax_checkpoint
from hyper_graph_nets_tpu.training.simulator import MeshSimulator as JaxMeshSimulator
from hyper_graph_nets_tpu_torch import main as port_main
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy, train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.serving import Predictor
from hyper_graph_nets_tpu_torch.training import checkpoint, task as port_task
from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
from hyper_graph_nets_tpu_torch.training.task import get_task
from hyper_graph_nets_tpu_torch.utils.config import read_yaml
from torch_port_cases import flag_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
N_TIMESTEPS, N_STEP = 10, 3


def _config(agg_vjp="fused", **model):
    config = flag_config(None, agg_vjp=agg_vjp)
    config["params"]["task"] = {
        "task": "mesh", "dataset": "flag_minimal", "batch_size": 4, "epochs": 1,
        "n_timesteps": N_TIMESTEPS, "trajectories": 1,
        "test": {"trajectories": 1, "rollouts": 1, "n_step_rollouts": 1, "n_steps": N_STEP},
        "validation": {"trajectories": 1, "rollouts": 1, "n_viz": 1},
    }
    config["params"]["model"].update(noise=0.003, gamma=0.9, learning_rate=1e-4, **model)
    config["params"]["random_seed"] = 0
    return config


def _jax_numpy(jts):
    """The JAX train state's numpy trees, in convert's argument order."""
    adam = jts.opt_state[0]
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in jts.model.normalizers.items()
    }
    tree = lambda t: jax.tree.map(np.asarray, t)
    return tree(jts.model.params), normalizers, tree(adam.mu), tree(adam.nu), adam.count, jts.step


def jax_noise(key):
    """A stand-in for ``MeshSimulator._normal`` that returns the JAX
    simulator's draws from ``key`` on, in order."""
    keys = [key]

    def normal(shape):
        keys[0], k = jax.random.split(keys[0])
        _, nkey, _ = jax.random.split(k, 3)
        return torch.from_numpy(np.array(jax.random.normal(nkey, tuple(shape), jnp.float32)))

    return normal


LR, ADAM_EPS = 1e-4, 1e-8


def _assert_state_close(ts, jts, first_grads=None):
    """Parameters within 1e-6 (0.1 lr where ``first_grads``, the first Adam
    step's gradients, lie within 10 eps of 0), normalizers within rtol 1e-5
    and 1e-5 of the field's largest magnitude, the same step."""
    want = state_from_jax_numpy(*_jax_numpy(jts)[:2])
    wparams = dict(want.params.named_parameters())
    for name, p in ts.model.params.named_parameters():
        atol = torch.full_like(p, 1e-6)
        if first_grads is not None:
            g = first_grads[name]
            tiny = (g != 0) & (g.abs() < 10 * ADAM_EPS)
            atol[tiny] = 0.1 * LR
        err = (p.detach() - wparams[name].detach()).abs()
        assert bool((err <= atol).all()), (name, float(err.max()))
    for name, ns in want.normalizers.items():
        for f in NORMALIZER_FIELDS:
            w = getattr(ns, f).numpy()
            np.testing.assert_allclose(
                getattr(ts.model.normalizers[name], f).numpy(), w, rtol=1e-5,
                atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}.{f}",
            )
    assert ts.step == int(jts.step)


class _Fitted:
    """Both simulators on the same initial state, after one fit of the
    first training trajectory with the same noise."""

    def __init__(self, root):
        self.config = _config()
        self.data_dir = str(root / "data")
        self.jsim = JaxMeshSimulator(self.config, out_dir=str(root / "jax_out"))
        jts = self.jsim.initialize()
        self.sim = MeshSimulator(self.config, out_dir=str(root / "port_out"), device="cpu")
        self.sim.initialize()
        ts = train_state_from_jax_numpy(self.sim.trainer, *_jax_numpy(jts))
        self.sim._normal = jax_noise(self.jsim._key)
        self.first_grads = {}
        loss_and_grads = self.sim.trainer.loss_and_grads

        def recording(tstate, *args, **kwargs):
            out = loss_and_grads(tstate, *args, **kwargs)
            if not self.first_grads:
                self.first_grads = {n: p.grad.clone() for n, p in tstate.model.params.named_parameters()}
            return out

        self.sim.trainer.loss_and_grads = recording
        traj = next(iter(jax_get_data(self.config, "train", data_dir=self.data_dir)))
        self.jts, self.jlosses = self.jsim.fit_trajectory(jts, traj)
        self.ts, self.losses = self.sim.fit_trajectory(ts, traj)

    def data(self, split):
        return jax_get_data(self.config, split, data_dir=self.data_dir)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    return _Fitted(tmp_path_factory.mktemp("fit"))


def test_fit_trajectory_matches_jax(fitted):
    """Same batch order (shuffled by the seeded RandomState: the batches
    hold 4, 4 and 2 frames, and JAX's draws fit only in JAX's order), the
    same losses, and the same parameters, normalizers and step after it."""
    assert len(fitted.losses) == 3
    np.testing.assert_allclose(fitted.losses, fitted.jlosses, rtol=1e-5)
    _assert_state_close(fitted.ts, fitted.jts, fitted.first_grads)
    records = open(os.path.join(fitted.sim.out_dir, "run.metrics.jsonl")).read()
    assert '"edges_per_s"' in records and '"loss per trajectory"' in records


def test_one_step_evaluator_matches_jax(fitted):
    got = fitted.sim.one_step_evaluator(fitted.ts, fitted.data("valid"), n_trajectories=1)
    want = fitted.jsim.one_step_evaluator(fitted.jts, fitted.data("valid"), n_trajectories=1)
    for k in ("validation_loss", "position_error"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert os.path.isfile(os.path.join(fitted.sim.out_dir, "one_step_eval.csv"))


def test_rollout_evaluator_matches_jax(fitted):
    got = fitted.sim.rollout_evaluator(fitted.ts, fitted.data("valid"), n_rollouts=1, num_steps=N_TIMESTEPS)
    want = fitted.jsim.rollout_evaluator(fitted.jts, fitted.data("valid"), n_rollouts=1, num_steps=N_TIMESTEPS)
    for k in ("rollout_loss", "rollout_loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["mse_curve"], want["mse_curve"], rtol=1e-5)
    np.testing.assert_allclose(
        got["rollouts"][0]["pred_pos"], np.asarray(want["rollouts"][0]["pred_pos"]), rtol=1e-5, atol=1e-6
    )
    assert os.path.isfile(os.path.join(fitted.sim.out_dir, "rollouts.pkl"))


def test_n_step_evaluator_matches_jax(fitted):
    """Chunks of 4 windows (``n_step_chunk``), so the 7 windows of 10 frames
    at n = 3 run as a full chunk and a short one."""
    for sim in (fitted.sim, fitted.jsim):
        sim.model.params["model"]["n_step_chunk"] = 4
    got = fitted.sim.n_step_evaluator(
        fitted.ts, fitted.data("valid"), n_step=N_STEP, n_trajectories=1, num_timesteps=N_TIMESTEPS
    )
    want = fitted.jsim.n_step_evaluator(
        fitted.jts, fitted.data("valid"), n_step=N_STEP, n_trajectories=1, num_timesteps=N_TIMESTEPS
    )
    for k in ("n_step_loss", "n_step_last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_segmented_rollout_continues_from_its_carry(fitted):
    """A rollout split at frame 4 and continued from the carry is the
    whole rollout (what the segmented rollout of an expansion that resets
    mid-rollout relies on)."""
    traj = next(iter(fitted.data("valid")))
    sim, state = fitted.sim, fitted.ts.model
    topo = sim._topology(traj)
    with torch.no_grad():
        whole, mse = sim.model.rollout(state, topo, traj, num_steps=N_TIMESTEPS)
        first, mse1, carry = sim.model.rollout(state, topo, traj, num_steps=4, return_carry=True)
        rest = {k: v[4:] for k, v in traj.items()}
        second, mse2 = sim.model.rollout(state, topo, rest, num_steps=N_TIMESTEPS - 4, start_carry=carry)
    assert torch.equal(torch.cat([first["pred_pos"], second["pred_pos"]]), whole["pred_pos"])
    assert torch.equal(torch.cat([mse1, mse2]), mse)
    assert sim.model.carry_to_frame(carry)["world_pos"] is carry[1]


def test_simulator_relabels_the_meshes_jax_relabels(fitted):
    """A randomly relabelled 50x50 grid fails the band criterion and both
    simulators relabel it with the same permutation; a grid passes and
    stays as it is."""
    from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
    from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation

    traj = jax_flag_trajectory(num_steps=3, nx=50, ny=50)
    relabel = np.random.default_rng(3).permutation(2500).astype(np.int32)
    inverse = np.argsort(relabel)
    shuffled = {k: (relabel[v] if k == "cells" else v[:, inverse]) for k, v in traj.items()}
    got, want = fitted.sim._maybe_reorder(shuffled), fitted.jsim._maybe_reorder(shuffled)
    assert not np.array_equal(got["cells"], shuffled["cells"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    grid = {"cells": _grid_triangulation(50, 50)[None], "node_type": traj["node_type"][:1]}
    assert fitted.sim._maybe_reorder(grid) is grid


# -- checkpoints -------------------------------------------------------------------

JAX_CHECKPOINT_GLOBALS = {
    ("hyper_graph_nets_tpu.training.trainer", "TrainState"),
    ("hyper_graph_nets_tpu.models.base", "ModelState"),
    ("hyper_graph_nets_tpu.core.normalizer", "NormalizerState"),
    ("optax._src.transform", "ScaleByAdamState"),
}


def pickle_globals(data: bytes) -> set:
    """The (module, name) of every global a pickle names (pickletools:
    GLOBAL, and STACK_GLOBAL on the two strings pushed before it, memo
    references followed)."""
    found, pushed, memo = set(), [], {}
    for op, arg, _ in pickletools.genops(data):
        if op.name == "GLOBAL":
            found.add(tuple(arg.split(" ", 1)))
        elif op.name == "STACK_GLOBAL":
            found.add((pushed[-2], pushed[-1]))
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE", "BINUNICODE8"):
            pushed.append(arg)
        elif op.name in ("BINGET", "LONG_BINGET", "GET"):
            pushed.append(memo.get(arg))
        elif op.name == "MEMOIZE":
            memo[len(memo)] = pushed[-1] if pushed else None
        elif op.name in ("BINPUT", "LONG_BINPUT", "PUT"):
            memo[arg] = pushed[-1] if pushed else None
        elif op.stack_after and op.name not in ("MEMOIZE",):
            pushed.append(None)
    return found


@pytest.mark.parametrize("decay", [False, True], ids=["constant_lr", "decayed_lr"])
def test_jax_checkpoint_loads_and_its_next_adam_step_matches(fitted, tmp_path, decay):
    """A checkpoint the JAX package's ``checkpoint.save`` wrote after the
    fit names exactly the classes the port's unpickler maps (pickletools),
    loads into the port, and the next train step on both sides (same noise)
    gives the same loss and parameters.  With the decayed rate the schedule
    reads the restored step."""
    config = _config(**({"lr_decay_steps": 2, "lr_decay_rate": 0.5, "lr_min": 1e-7} if decay else {}))
    jsim = JaxMeshSimulator(config, out_dir=str(tmp_path / "jax"))
    jts = jsim.initialize()
    adam = fitted.jts.opt_state[0]
    tail = tuple(s._replace(count=adam.count) if "count" in s._fields else s for s in jts.opt_state[1:])
    # copies: the JAX train step below donates its state
    jts = jax.tree.map(jnp.array, jts.replace(model=fitted.jts.model, step=fitted.jts.step, opt_state=(adam,) + tail))
    path = jax_checkpoint.save(str(tmp_path / "jax"), config, jts, 1)
    with open(path, "rb") as f:
        names = pickle_globals(f.read())
    jax_names = {n for n in names if not n[0].startswith("numpy")}
    tail = ("optax._src.transform", "ScaleByScheduleState") if decay else ("optax._src.base", "EmptyState")
    assert jax_names == JAX_CHECKPOINT_GLOBALS | {tail}
    assert jax_names <= set(checkpoint.JAX_GLOBALS)
    assert names - jax_names <= checkpoint.NUMPY_GLOBALS

    sim = MeshSimulator(config, out_dir=str(tmp_path / "port"), device="cpu")
    assert checkpoint.latest(str(tmp_path / "jax"), config) == (path, 1)
    ts, epoch, _ = checkpoint.load(path, sim.trainer)
    assert epoch == 1 and ts.step == 3
    _assert_state_close(ts, fitted.jts)

    traj = next(iter(fitted.data("train")))
    frames = {k: v[:4] for k, v in traj.items()}
    key = jax.random.PRNGKey(5)
    step = jsim.trainer.make_train_step(jsim._topology(traj))
    jts2, jloss = step(jts, {k: jnp.asarray(v) for k, v in frames.items() if k != "cells"}, key)
    _, nkey, _ = jax.random.split(key, 3)  # the draw of the step given ``key``
    draw = torch.from_numpy(np.array(jax.random.normal(nkey, frames["world_pos"].shape, jnp.float32)))
    ts2, loss = sim.trainer.train_step(ts, sim._topology(traj), sim.trainer.frames(frames), normal=draw)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_state_close(ts2, jts2)
    if decay:
        assert ts2.opt_state.param_groups[0]["lr"] == pytest.approx(1e-4 * 0.5 ** 1.5)


def test_jax_checkpoint_loads_without_jax(fitted, tmp_path):
    """In a fresh interpreter the port loads a JAX checkpoint and serves
    from it with neither jax, flax, optax nor the JAX package imported."""
    path = jax_checkpoint.save(str(tmp_path), fitted.config, fitted.jts, 1)
    code = (
        "import sys\n"
        "from hyper_graph_nets_tpu_torch.serving import Predictor\n"
        "from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator\n"
        "from hyper_graph_nets_tpu_torch.training import checkpoint\n"
        f"config = {fitted.config!r}\n"
        f"sim = MeshSimulator(config, out_dir={str(tmp_path / 'out')!r}, device='cpu')\n"
        f"ts, epoch, _ = checkpoint.load({path!r}, sim.trainer)\n"
        f"p = Predictor.from_config(config, checkpoint={str(tmp_path)!r}, device='cpu')\n"
        "assert epoch == 1 and ts.step == 3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'hyper_graph_nets_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _stack_global_pickle(module: str, name: str) -> bytes:
    """A protocol-4 pickle of the one global ``module``, ``name``."""
    m, n = module.encode(), name.encode()
    return b"\x80\x04\x8c" + bytes([len(m)]) + m + b"\x8c" + bytes([len(n)]) + n + b"\x93."


@pytest.mark.parametrize("module,name", [
    ("posix", "system"), ("numpy", "load"), ("numpy", "save"), ("numpy", "ctypeslib.load_library"),
    ("numpy._core.multiarray", "_reconstruct.__globals__"),
])
def test_unknown_globals_are_refused(tmp_path, module, name):
    """Only the JAX classes and the numpy array globals resolve: any other
    name, a numpy function or a dotted name through an allowed one, raises
    before anything is called."""
    import pickle

    path = tmp_path / "model_0_cluster:none_connector:none_balancer:none_mp:2_epoch:1.pkl"
    path.write_bytes(_stack_global_pickle(module, name))
    sim = MeshSimulator(_config(), out_dir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(pickle.UnpicklingError, match="does not name"):
        checkpoint.load(str(path), sim.trainer)


def test_port_checkpoint_round_trip_and_latest(fitted, tmp_path):
    """save -> latest -> load gives the same weights, normalizers, Adam
    state and step; the JAX package's ``latest`` does not see the ``.pt``
    file; the port's takes the newer epoch of either kind, its own on a
    tie."""
    d = str(tmp_path)
    path = checkpoint.save(d, fitted.config, fitted.ts, 1)
    assert path.endswith(".pt") and jax_checkpoint.latest(d, fitted.config) is None
    assert checkpoint.latest(d, fitted.config) == (path, 1)
    sim = MeshSimulator(fitted.config, out_dir=str(tmp_path / "out"), device="cpu")
    ts, epoch, extra = checkpoint.load(path, sim.trainer)
    assert (epoch, extra, ts.step) == (1, {}, fitted.ts.step)
    for (n, p), (_, q) in zip(ts.model.params.named_parameters(), fitted.ts.model.params.named_parameters()):
        assert torch.equal(p, q), n
        s, t = ts.opt_state.state[p], fitted.ts.opt_state.state[q]
        assert all(torch.equal(s[k], t[k]) for k in ("step", "exp_avg", "exp_avg_sq")), n
    for name, ns in fitted.ts.model.normalizers.items():
        assert all(torch.equal(getattr(ts.model.normalizers[name], f), getattr(ns, f)) for f in NORMALIZER_FIELDS)

    jax_path = jax_checkpoint.save(d, fitted.config, fitted.jts, 1)
    assert checkpoint.latest(d, fitted.config) == (path, 1)
    newer = jax_checkpoint.save(d, fitted.config, fitted.jts, 2)
    assert checkpoint.latest(d, fitted.config) == (newer, 2)
    assert jax_checkpoint.latest(d, fitted.config) == (newer, 2) and jax_path != newer


def test_orbax_backend_raises(fitted, tmp_path):
    config = _config()
    config["params"]["logging"] = {"checkpoint_backend": "orbax"}
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.save(str(tmp_path), config, fitted.ts, 1)


# -- the task, the CLI and serving ---------------------------------------------------


def test_task_resumes_and_skips_training(tmp_path, monkeypatch):
    """A task trains an epoch and writes its checkpoint; a second task on
    the same directory resumes at epoch 1 and trains nothing; with
    ``retrain`` it starts over.  Its scalars are finite and the served state
    from the checkpoint predicts bit for bit what the task's state does."""
    config = _config()
    task = get_task(config, data_dir=str(tmp_path), device="cpu")
    task.run_iterations()
    out = task.out_dir
    assert os.path.isfile(os.path.join(out, checkpoint.checkpoint_name(config, 1)))
    scalars = task.get_scalars()
    assert set(scalars) == {"test_loss", "test_position_error", "test_rollout_loss", "test_n_step_loss"}
    assert all(np.isfinite(v) for v in scalars.values())

    again = get_task(config, data_dir=str(tmp_path), device="cpu")
    assert again.start_epoch == 1 and again.tstate.step == task.tstate.step == 3
    monkeypatch.setattr(again.simulator, "fit_trajectory", lambda *a, **k: pytest.fail("trained"))
    again.run_iterations()
    assert '"resumed_from_epoch": 1.0' in open(os.path.join(out, "run.metrics.jsonl")).read()
    retrain = _config()
    retrain["params"]["retrain"] = True
    assert get_task(retrain, data_dir=str(tmp_path), device="cpu").start_epoch == 0

    traj = next(iter(jax_get_data(config, "test", data_dir=str(tmp_path))))
    served = Predictor.from_config(config, checkpoint=out, device="cpu").one_step(traj)
    direct = Predictor(config, state=task.tstate.model, device="cpu").one_step(traj)
    assert np.array_equal(served, direct)
    with pytest.raises(FileNotFoundError):
        Predictor.from_config(config, checkpoint=str(tmp_path / "nothing"), device="cpu")


def test_predictor_serves_a_jax_checkpoint(fitted, tmp_path):
    path = jax_checkpoint.save(str(tmp_path), fitted.config, fitted.jts, 1)
    traj = next(iter(fitted.data("test")))
    served = Predictor.from_config(fitted.config, checkpoint=path, device="cpu").one_step(traj)
    state = state_from_jax_numpy(*_jax_numpy(fitted.jts)[:2])
    assert np.array_equal(served, Predictor(fitted.config, state=state, device="cpu").one_step(traj))


@contextlib.contextmanager
def _one_cpu_thread():
    """PyTorch's CPU operations on one thread inside the block.  The CLI's
    epoch is thousands of small operations; on a machine whose cores other
    test processes keep busy, each multi-threaded one waits at its barrier
    for threads that are not running (this test took 14.5 s alone and 413 s
    in a run of the suite on 6 workers; with 5 other busy processes, 147 s
    on 8 threads and 67 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_cli_runs_flag_fused_demo_and_resumes(tmp_path, capsys):
    """``python -m hyper_graph_nets_tpu_torch.main flag_fused_demo --cpu``:
    exit 0 with the four finite test scalars, then a second run resumes."""
    args = ["flag_fused_demo", "--cpu", "--data-dir", str(tmp_path)]
    with _one_cpu_thread():
        assert port_main.main(args) == 0
        lines = dict(line.split(": ") for line in capsys.readouterr().out.strip().splitlines()[-4:])
        assert set(lines) == {"test_loss", "test_position_error", "test_rollout_loss", "test_n_step_loss"}
        assert all(np.isfinite(float(v)) for v in lines.values())
        assert port_main.main(args) == 0
    out = os.path.join(tmp_path, "flag_simple", "output")
    assert '"resumed_from_epoch": 1.0' in open(os.path.join(out, "run.metrics.jsonl")).read()
    assert read_yaml("flag_fused_demo")["params"]["task"]["dataset"] == "flag_simple"


def test_cli_exits_1_on_non_finite_scalars(monkeypatch, capsys):
    class NanTask:
        def run_iterations(self):
            pass

        def get_scalars(self):
            return {"test_loss": float("nan"), "test_rollout_loss": 1.0}

    monkeypatch.setattr(port_task, "get_task", lambda *a, **k: NanTask())
    assert port_main.main(["flag_fused_demo", "--cpu"]) == 1
    assert "non-finite scalars: test_loss" in capsys.readouterr().err


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["flag_fused_demo", "--data-dir", str(tmp_path)])


def _balancer_sims(tmp_path, frequency):
    """Both simulators with the Ricci balancer (SDRF, 4 loops) on the same
    converted state; ``agg_vjp: gather`` on both sides (the JAX fused path
    aggregates removed mesh edges: ROADMAP section 3)."""
    config = _config(
        agg_vjp="gather",
        graph_balancer={"algorithm": "ricci", "frequency": frequency, "remove_edges": True,
                        "ricci": {"loops": 4, "tau": 150}},
    )
    jsim = JaxMeshSimulator(config, out_dir=str(tmp_path / "jax"))
    jts = jsim.initialize()
    sim = MeshSimulator(config, out_dir=str(tmp_path / "port"), device="cpu")
    ts = train_state_from_jax_numpy(sim.trainer, *_jax_numpy(jts))
    data = lambda: jax_get_data(config, "valid", data_dir=str(tmp_path / "data"))
    return (sim, ts), (jsim, jts), data


def test_balancer_one_step_evaluator_matches_jax(tmp_path):
    (sim, ts), (jsim, jts), data = _balancer_sims(tmp_path, 1)
    got = sim.one_step_evaluator(ts, data(), n_trajectories=1)
    want = jsim.one_step_evaluator(jts, data(), n_trajectories=1)
    for k in ("validation_loss", "position_error"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert int(sim.expansion.static[0].bal_mask.sum()) > 0


def test_segmented_rollout_with_the_balancer_matches_jax(tmp_path):
    """With the balancer's frequency 2 the rollout evaluator runs in two
    segments (reset at frames 0 and 5), each prepared on the predicted
    state carried over, as the JAX simulator's ``_segmented_rollout``."""
    (sim, ts), (jsim, jts), data = _balancer_sims(tmp_path, 2)
    got = sim.rollout_evaluator(ts, data(), n_rollouts=1, num_steps=N_TIMESTEPS, save=False)
    want = jsim.rollout_evaluator(jts, data(), n_rollouts=1, num_steps=N_TIMESTEPS, save=False)
    np.testing.assert_allclose(got["mse_curve"], want["mse_curve"], rtol=1e-5)
    for k in ("pred_pos", "gt_pos"):
        np.testing.assert_allclose(got["rollouts"][0][k], np.asarray(want["rollouts"][0][k]), rtol=1e-5, atol=1e-6)
    assert got["rollouts"][0]["pred_pos"].shape == (N_TIMESTEPS, 64, 3)


def test_new_modules_import_no_jax_and_no_matplotlib():
    """The task loop's modules import neither JAX nor the JAX package, and
    matplotlib only when a GIF is drawn."""
    code = (
        "import sys\n"
        "import hyper_graph_nets_tpu_torch.main, hyper_graph_nets_tpu_torch.training.task\n"
        "import hyper_graph_nets_tpu_torch.training.simulator, hyper_graph_nets_tpu_torch.training.checkpoint\n"
        "import hyper_graph_nets_tpu_torch.training.get_algorithm, hyper_graph_nets_tpu_torch.data.loader\n"
        "import hyper_graph_nets_tpu_torch.data.tfrecord, hyper_graph_nets_tpu_torch.ops.reorder\n"
        "import hyper_graph_nets_tpu_torch.utils.metrics, hyper_graph_nets_tpu_torch.utils.recorder\n"
        "import hyper_graph_nets_tpu_torch.utils.viz, hyper_graph_nets_tpu_torch.serving\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'hyper_graph_nets_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_recorder_writes_its_logs(tmp_path):
    from hyper_graph_nets_tpu_torch.utils.recorder import Recorder

    rec = Recorder(str(tmp_path), config={"a": 1})
    rec.record({"loss": 0.5})
    rec.finalize()
    line = open(tmp_path / "scalars.jsonl").read()
    assert '"loss": 0.5' in line and "max_rss_kb" in line
    assert open(tmp_path / "config.json").read().strip().startswith("{")


def test_gif_without_matplotlib_is_skipped(fitted, tmp_path, monkeypatch, caplog):
    """With matplotlib absent the task writes no GIF, logs why, and goes on."""
    from hyper_graph_nets_tpu_torch.utils import viz

    ops = {"pred_pos": np.zeros((2, 4, 3)), "gt_pos": np.zeros((2, 4, 3)), "faces": np.zeros((2, 1, 3), int)}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert viz.animate_rollout(ops, "flag", str(tmp_path / "x.gif")) is None
    assert "matplotlib is not installed" in caplog.text and not os.path.exists(tmp_path / "x.gif")
