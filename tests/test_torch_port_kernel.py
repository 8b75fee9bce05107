"""K1, the fused edge block: the port against the JAX package's Pallas kernel.

On the CPU the port's ``fused_edge_block`` runs its plain PyTorch version;
the JAX side runs ``_fwd_kernel`` in interpret mode, as
tests/test_fused_block.py does.  The inputs hold an isolated receiver and a
masked tail of padding edges, or receivers with more edges than one chunk.

Tolerances:
- float32: rtol = atol = 1e-5 (only the summation order differs).
- bf16: e2 within rtol = 2**-7 and atol = 2**-5.  The port rounds at every
  point the kernel's code names, while XLA on the CPU may keep an
  elementwise chain in float32 between them (excess precision), so single
  elements differ by one rounding: one bf16 unit in the last place is
  2**-7 of the value, and 2**-5 for a LayerNorm output in [4, 8), which
  e2 = e + LN(z3) can cancel down to a small value.  The aggregate sums up
  to 7 such elements: rtol = atol = 2**-5.  With receivers of 150 edges
  the sum's atol grows to 150 * 2**-5.
The masked edges' own e2 is not compared: the JAX kernel gathers zero rows
for them through its padding sentinel, while the port gathers the rows the
edge names; neither reaches an aggregate.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_port_cuda.py.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.ops.pallas.fused_block import (
    build_band_plan,
    fused_edge_block as jax_fused_edge_block,
)
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    fused_edge_block,
    plan_segments,
)
from torch_port_cases import BF16_ULP, long_segment_case, masked_edge_case

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOLS = {
    "float32": dict(e2=(1e-5, 1e-5), agg=(1e-5, 1e-5)),
    "bfloat16": dict(e2=(BF16_ULP, 4 * BF16_ULP), agg=(4 * BF16_ULP, 4 * BF16_ULP)),
}


def _port_inputs(arrays, weights, snd, rcv, mask, tdt, device="cpu"):
    """Torch inputs holding exactly the JAX side's (rounded) values."""
    t = {k: torch.tensor(v).to(tdt).to(device) for k, v in arrays.items()}
    w = {
        k: torch.tensor(v.T.copy() if v.ndim == 2 else v).to(device)
        for k, v in weights.items()
    }
    idx = lambda a: torch.tensor(a).to(device)
    return t, w, idx(snd), idx(rcv), idx(mask)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k1_plain_matches_jax_kernel(dtype):
    arrays, weights, snd, rcv, mask, N, num_valid = masked_edge_case()
    jdt, tdt = DTYPES[dtype]
    plan = build_band_plan(snd, rcv, N, num_valid=num_valid, chunk=128)
    je2, jagg = jax_fused_edge_block(
        *(jnp.asarray(arrays[k]).astype(jdt) for k in ("e", "sp", "rp")),
        {k: jnp.asarray(v) for k, v in weights.items()},
        plan, N, interpret=True,
    )
    je2 = np.asarray(je2.astype(jnp.float32))
    jagg = np.asarray(jagg)

    before = fused_edge_block.launches
    t, w, ts, tr, tm = _port_inputs(arrays, weights, snd, rcv, mask, tdt)
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, tm, N)
    assert fused_edge_block.launches == before  # the CPU runs the plain version
    assert e2.dtype == tdt and agg.dtype == torch.float32
    assert agg.shape == (2, N, 4 * 32)

    (er, ea), (gr, ga) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    np.testing.assert_allclose(
        e2.float().numpy()[:, :num_valid], je2[:, :num_valid], rtol=er, atol=ea
    )
    np.testing.assert_allclose(agg.numpy(), jagg, rtol=gr, atol=ga)
    # the isolated receiver and the receiver of the masked tail
    assert np.all(agg.numpy()[:, 10] == 0.0)
    np.testing.assert_allclose(agg.numpy()[:, N - 1], jagg[:, N - 1], rtol=gr, atol=ga)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k1_plain_matches_jax_kernel_long_segments(dtype):
    """Receivers with more edges than a JAX chunk (and than a CUDA tile)."""
    arrays, weights, snd, rcv, _, N = long_segment_case()
    jdt, tdt = DTYPES[dtype]
    plan = build_band_plan(snd, rcv, N, chunk=128)
    je2, jagg = jax_fused_edge_block(
        *(jnp.asarray(arrays[k]).astype(jdt) for k in ("e", "sp", "rp")),
        {k: jnp.asarray(v) for k, v in weights.items()},
        plan, N, interpret=True,
    )
    t, w, ts, tr, _ = _port_inputs(arrays, weights, snd, rcv, np.ones(len(snd), np.float32), tdt)
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, None, N)
    (er, ea), (gr, ga) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    np.testing.assert_allclose(
        e2.float().numpy(), np.asarray(je2.astype(jnp.float32)), rtol=er, atol=ea
    )
    # in bf16 each of a long segment's 150 summands may differ by one
    # rounding of e2, so the sum's atol grows with the count; mean, max and
    # min keep theirs
    L = e2.shape[-1]
    agg, jagg = agg.numpy(), np.asarray(jagg)
    sum_atol = ga if dtype == "float32" else ga * 150
    np.testing.assert_allclose(agg[..., L:], jagg[..., L:], rtol=gr, atol=ga)
    np.testing.assert_allclose(agg[..., :L], jagg[..., :L], rtol=gr, atol=sum_atol)
    assert np.all(agg[:, 9] == 0.0)


def test_k1_unbatched_equals_batched_rows():
    arrays, weights, snd, rcv, mask, N, _ = masked_edge_case(seed=1)
    t, w, ts, tr, tm = _port_inputs(arrays, weights, snd, rcv, mask, torch.float32)
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, ts, tr, tm, N)
    e2_1, agg_1 = fused_edge_block(t["e"][1], t["sp"][1], t["rp"][1], w, ts, tr, tm, N)
    assert torch.equal(e2[1], e2_1) and torch.equal(agg[1], agg_1)


def test_plan_segments_rows_and_groups():
    rcv = np.array([0, 0, 2, 2, 2, 3] + [5] * 70, np.int32)
    plan = plan_segments(rcv, 7, tile=4)
    assert plan.row_ptr.tolist() == [0, 2, 2, 5, 6, 6, 76, 76]
    groups = plan.groups.tolist()
    assert groups[0] == 0 and groups[-1] == 7
    rp = plan.row_ptr.numpy()
    assert groups == sorted(set(groups))
    for a, b in zip(groups[:-1], groups[1:]):
        # whole segments, at most a tile of edges unless one receiver has more
        receivers_with_edges = int(np.count_nonzero(np.diff(rp[a : b + 1])))
        assert rp[b] - rp[a] <= 4 or receivers_with_edges == 1
    assert plan.group_edges.tolist() == rp[groups].tolist()
    with pytest.raises(ValueError, match="non-decreasing"):
        plan_segments(np.array([1, 0], np.int32), 2)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        plan_segments(np.array([0, 2], np.int32), 2)


@pytest.mark.parametrize(
    "counts",
    [[2, 2, 2, 150, 2, 2], [64, 64, 1], [3] * 40 + [0] * 5, [70], [2] * 10 + [0] * 300,
     [0, 0, 1] * 100 + [130]],
    ids=["receiver-over-two-tiles", "full-tiles", "empty-receivers-at-the-end", "one-receiver",
         "empty-receivers-over-a-group", "sparse-shard-then-long-segment"],
)
def test_plan_group_edges_follow_the_groups(counts):
    """K1 reads each group's edge range from ``group_edges`` (row_ptr at the
    group boundaries): it starts at 0, ends at E, and a group holds at most
    a tile of edges unless one receiver owns them all, and at most
    ``GROUP_NODES`` receivers (a halo shard leaves most receivers empty)."""
    from hyper_graph_nets_tpu_torch.ops.fused_block import GROUP_NODES, TILE

    rcv = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    plan = plan_segments(rcv, len(counts))
    rp, groups, ge = plan.row_ptr.numpy(), plan.groups.numpy(), plan.group_edges.numpy()
    assert ge.dtype == np.int32 and ge.tolist() == rp[groups].tolist()
    assert ge[0] == 0 and ge[-1] == len(rcv) and np.all(np.diff(ge) >= 0)
    for a, b in zip(groups[:-1], groups[1:]):
        owners = int(np.count_nonzero(np.diff(rp[a : b + 1])))
        assert rp[b] - rp[a] <= TILE or owners == 1
        assert 0 < b - a <= GROUP_NODES
    # greedy: a group closes only when the next receiver would break a limit
    for a, b in zip(groups[:-2], groups[1:-1]):
        assert rp[b + 1] - rp[a] > TILE or b + 1 - a > GROUP_NODES
    moved = plan.to("cpu")
    assert torch.equal(moved.group_edges, plan.group_edges)


def test_build_key_covers_included_headers(tmp_path):
    """A change to a header a kernel source includes gives the source a new
    library (the kernels share fused_block_common.cuh; K1 and K7 share
    fused_block_fwd.cuh, K6 and K7 ring_common.cuh), transitively."""
    from hyper_graph_nets_tpu_torch.ops import build

    for name, want in (
        ("fused_block_fwd.cu", ["fused_block_common.cuh", "fused_block_fwd.cuh"]),
        ("fused_block_bwd.cu", ["fused_block_common.cuh"]),
        ("fused_overlap.cu", ["fused_block_common.cuh", "fused_block_fwd.cuh", "ring_common.cuh"]),
        ("ring.cu", ["ring_common.cuh"]),
    ):
        headers = build._local_headers(build.source_path(name))
        assert [os.path.basename(h) for h in headers] == want
    src, inner, outer = tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"
    src.write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    inner.write_text('#include "b.cuh"\n')
    outer.write_text("// v1\n")
    first = build.library_path(str(src))
    outer.write_text("// v2\n")
    assert build.library_path(str(src)) != first


def test_build_key_covers_defines():
    """A probe build (the backward kernels' phase clock, -DHGN_BWD_PHASES)
    gets a library of its own, and the main path's key is the one without
    defines."""
    from hyper_graph_nets_tpu_torch.ops import build
    from hyper_graph_nets_tpu_torch.ops.fused_block import BWD_SOURCE

    src = build.source_path(BWD_SOURCE)
    main = build.library_path(src)
    assert build.library_path(src, ()) == main
    probe = build.library_path(src, ("HGN_BWD_PHASES",))
    assert probe != main and os.path.dirname(probe) == os.path.dirname(main)
    with open(src) as f:
        assert "#ifdef HGN_BWD_PHASES" in f.read()


def _kernel_times():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "torch_port", "kernel_times.py")
    spec = importlib.util.spec_from_file_location("kernel_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("change", ["none", "dpar order", "dh", "drp"])
def test_kernel_times_holds_k2_k3_outputs_to_another_checkout(tmp_path, change):
    """``kernel_times.py --grads``: a1/a2 and de, dh, dz2, dz3 must equal the
    other checkout's bit for bit, dsp/drp lie within rtol 1e-5 and dpar
    within relative L2 1e-4 per row."""
    kt = _kernel_times()
    gen = torch.Generator().manual_seed(0)
    outs = {"case": {"K2": {n: torch.randn(4, 8, generator=gen) for n in kt.K2_NAMES}}}
    assert kt.hold_grads(torch, "parent", outs, str(tmp_path))
    other = {"case": {"K2": {n: t.clone() for n, t in outs["case"]["K2"].items()}}}
    named = other["case"]["K2"]
    if change == "dpar order":  # a float32 sum in another order
        named["dpar"] = named["dpar"] * (1 + 1e-7)
    elif change == "dh":  # one element one bf16 unit away
        named["dh"][0, 0] = named["dh"][0, 0] * (1 + 2.0**-7)
    elif change == "drp":
        named["drp"][1, 1] += 1.0
    assert kt.hold_grads(torch, "change", other, str(tmp_path)) == (change in ("none", "dpar order"))
