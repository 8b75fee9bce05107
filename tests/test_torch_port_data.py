"""The port's data path against the JAX package's: TFRecord bytes and
CRC32C, the synthetic dataset on disk, ``get_data``, and the relabel
decision (the JAX fused kernel's band criterion and reverse Cuthill-McKee).

Everything here is integer or byte data, or float arrays copied unchanged:
every comparison is exact.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from hyper_graph_nets_tpu.core.mesh import cells_to_edges as jax_cells_to_edges
from hyper_graph_nets_tpu.data import tfrecord as jax_tfrecord
from hyper_graph_nets_tpu.data.loader import get_data as jax_get_data
from hyper_graph_nets_tpu.data.preprocessing import trajectory_windows as jax_trajectory_windows
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.ops import reorder as jax_reorder
from hyper_graph_nets_tpu.ops.pallas.fused_block import check_banded as jax_check_banded
from hyper_graph_nets_tpu.ops.pallas.fused_block import plan_dims as jax_plan_dims
from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
from hyper_graph_nets_tpu_torch.data import loader, tfrecord
from hyper_graph_nets_tpu_torch.data.preprocessing import trajectory_windows
from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation, flag_trajectory
from hyper_graph_nets_tpu_torch.ops import reorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(dataset="flag_minimal", **task):
    return {
        "params": {
            "task": {"dataset": dataset, **task},
            "model": {"field": "world_pos", "history": True},
        }
    }


def test_crc32c_both_paths_match_jax():
    """The C path on lengths around its 8-byte stride and on 1 MB, the numpy
    fallback on the short ones, both against the JAX package's crc32c."""
    assert tfrecord.crc32c_backend() == "c"
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 1000, 1 << 20):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        want = jax_tfrecord.crc32c(data)
        assert tfrecord.crc32c(data) == want, n
        if n <= 1000:
            assert tfrecord.crc32c_numpy(data) == want, n
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value


def test_tfrecord_bytes_match_jax(tmp_path):
    trajs = [flag_trajectory(num_steps=5, nx=4, ny=3, seed=s) for s in (0, 1)]
    ours, theirs = tmp_path / "ours.tfrecord", tmp_path / "theirs.tfrecord"
    tfrecord.write_trajectories(str(ours), trajs)
    jax_tfrecord.write_trajectories(str(theirs), trajs)
    assert ours.read_bytes() == theirs.read_bytes()
    meta = {
        "trajectory_length": 5,
        "features": {
            k: {"type": "static" if k != "world_pos" else "dynamic",
                "shape": [1 if k != "world_pos" else 5, *v.shape[1:]], "dtype": str(v.dtype)}
            for k, v in trajs[0].items()
        },
    }
    got = list(tfrecord.read_trajectories(str(theirs), meta))
    want = list(jax_tfrecord.read_trajectories(str(ours), meta))
    assert len(got) == len(want) == 2
    for g, w, t in zip(got, want, trajs):
        for k in t:
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], t[k])
            assert g[k].flags.writeable


def test_corrupt_length_crc_raises(tmp_path):
    path = tmp_path / "x.tfrecord"
    tfrecord.write_trajectories(str(path), [flag_trajectory(num_steps=3, nx=3, ny=3)])
    raw = bytearray(path.read_bytes())
    raw[0] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt TFRecord length CRC"):
        next(tfrecord.read_records(str(path)))


def test_get_data_files_and_trajectories_match_jax(tmp_path):
    """Each package generates the synthetic flag_minimal dataset in its own
    directory: the files are the same bytes, the trajectories the same
    arrays, and the port reads the JAX package's directory."""
    config = _config(synthetic={"trajectories": 2, "num_steps": 6, "nx": 5, "ny": 4})
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    for split in ("train", "valid", "test"):
        got = list(loader.get_data(config, split, data_dir=mine))
        want = list(jax_get_data(config, split, data_dir=theirs))
        read_theirs = list(loader.get_data(config, split, data_dir=theirs))
        assert len(got) == len(want) == len(read_theirs) == (2 if split == "train" else 1)
        for g, w, r in zip(got, want, read_theirs):
            assert set(g) == set(w) == set(r)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                np.testing.assert_array_equal(r[k], w[k])
    in_mine, _ = loader.get_directories("flag_minimal", mine)
    in_theirs = os.path.join(theirs, "flag_minimal", "input")
    for name in ("train.tfrecord", "valid.tfrecord", "test.tfrecord", "meta.json"):
        with open(os.path.join(in_mine, name), "rb") as a, open(os.path.join(in_theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    raw = next(iter(loader.get_data(config, "train", add_targets=False, data_dir=mine)))
    assert raw["world_pos"].shape == (6, 20, 3) and "target|world_pos" not in raw
    got = trajectory_windows(raw, "world_pos", True, num_steps=3)
    want = jax_trajectory_windows(raw, "world_pos", True, num_steps=3)
    assert set(got) == set(want) and got["prev|world_pos"].shape == (3, 20, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_get_data_regenerates_a_truncated_split(tmp_path):
    config = _config(synthetic={"trajectories": 2, "num_steps": 4, "nx": 3, "ny": 3})
    first = list(loader.get_data(config, "valid", data_dir=str(tmp_path)))
    in_dir, _ = loader.get_directories("flag_minimal", str(tmp_path))
    open(os.path.join(in_dir, "valid.tfrecord"), "wb").close()
    again = list(loader.get_data(config, "valid", data_dir=str(tmp_path)))
    np.testing.assert_array_equal(again[0]["world_pos"], first[0]["world_pos"])


@pytest.mark.parametrize(
    "dataset, task, match",
    [
        ("airfoil", {}, "unknown dataset"),
        ("sphere_simple", {}, "unknown dataset"),
        ("flag_minimal", {"loader": "tfdata"}, "TensorFlow"),
    ],
    ids=["airfoil", "sphere", "tfdata"],
)
def test_later_datasets_and_tfdata_raise(tmp_path, dataset, task, match):
    """Datasets without a synthetic generator (the other DeepMind sets) and
    the TensorFlow loader raise; cylinder_flow and deforming_plate load
    (tests/test_torch_port_cylinder.py, test_torch_port_plate.py)."""
    with pytest.raises(NotImplementedError, match=match):
        loader.get_data(_config(dataset, **task), "train", data_dir=str(tmp_path))


def test_prefetch_thread_ends_when_the_consumer_stops(tmp_path):
    config = _config(synthetic={"trajectories": 6, "num_steps": 4, "nx": 3, "ny": 3})
    data = loader.get_data(config, "train", data_dir=str(tmp_path))
    before = threading.active_count()
    for i, _ in enumerate(data):
        if i == 0:
            break
    assert threading.active_count() == before
    assert len(data.take(10)) == 6

    class Failing:
        def __iter__(self):
            yield {}
            raise OSError("disk gone")

    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        list(loader.GraphDataLoader(Failing()))


def _relabelled_grid(nx, ny, seed):
    rng = np.random.default_rng(seed)
    cells = _grid_triangulation(nx, ny)
    relabel = rng.permutation(nx * ny).astype(np.int32)
    return relabel[cells]


@pytest.mark.parametrize(
    "nx, ny, shuffled, banded",
    [(8, 8, False, True), (40, 40, False, True), (50, 50, True, False), (8, 8, True, True)],
    ids=["grid-8", "grid-40", "shuffled-50", "shuffled-8"],
)
def test_band_criterion_and_rcm_match_jax(nx, ny, shuffled, banded):
    """The relabel decision is the JAX package's ``check_banded`` on both a
    grid (banded) and a randomly relabelled one (a 50x50 relabelled grid's
    windows exceed 2,048 nodes; an 8x8 one has too few nodes to), and the
    permutation is the same."""
    cells = _relabelled_grid(nx, ny, 3) if shuffled else _grid_triangulation(nx, ny)
    edges, jedges = cells_to_edges(cells), jax_cells_to_edges(cells)
    np.testing.assert_array_equal(edges.senders, jedges.senders)
    decision = reorder.check_banded(edges.senders, edges.receivers)
    assert decision == jax_check_banded(jedges.senders, jedges.receivers) == banded
    for chunk in (256, 512):
        d = jax_plan_dims(jedges.senders, jedges.receivers, chunk=chunk)
        assert reorder.window_dims(edges.senders, edges.receivers, chunk=chunk) == (d["W"], d["WR"])
    n = nx * ny
    perm = reorder.rcm_order(edges.senders, edges.receivers, n)
    np.testing.assert_array_equal(perm, jax_reorder.rcm_order(jedges.senders, jedges.receivers, n))
    assert reorder.bandwidth(edges.senders, edges.receivers) == jax_reorder.bandwidth(
        jedges.senders, jedges.receivers
    )
    traj = jax_flag_trajectory(num_steps=3, nx=nx, ny=ny)
    traj["cells"] = np.tile(cells[None], (3, 1, 1))
    got, want = reorder.reorder_trajectory(traj, perm), jax_reorder.reorder_trajectory(traj, perm)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    relabelled = cells_to_edges(got["cells"][0])
    assert reorder.check_banded(relabelled.senders, relabelled.receivers)


def test_unsorted_receivers_are_not_banded():
    snd = np.array([0, 1, 2], np.int32)
    rcv = np.array([2, 0, 1], np.int32)
    assert reorder.window_dims(snd, rcv) is None
    assert not reorder.check_banded(snd, rcv) and not jax_check_banded(snd, rcv)


def test_crc32c_falls_back_to_numpy_without_a_compiler(tmp_path):
    """With no compiler on PATH and no built library, the reader logs the
    fallback and still reads the JAX package's files."""
    jax_path = tmp_path / "x.tfrecord"
    jax_tfrecord.write_trajectories(str(jax_path), [jax_flag_trajectory(num_steps=3, nx=3, ny=3)])
    code = (
        "import os, sys, logging\n"
        "logging.basicConfig(level=logging.WARNING)\n"
        "from hyper_graph_nets_tpu_torch.ops import build\n"
        f"build.BUILD_DIR = {str(tmp_path / 'empty_build')!r}\n"
        "os.environ['PATH'] = ''\n"
        "from hyper_graph_nets_tpu_torch.data import tfrecord\n"
        "assert tfrecord.crc32c_backend() == 'numpy'\n"
        f"assert len(list(tfrecord.read_records({str(jax_path)!r}))) == 1\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert "numpy loop" in out.stderr
