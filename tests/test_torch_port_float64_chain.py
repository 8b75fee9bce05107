"""The float64 chain of K1, K2 and K3's plain versions, the yardstick of the
float32 kernels' accuracy on the card, and the host checks built on it.

The port's plain versions (``ops.fused_block``) run the whole chain in
float64 when their inputs are float64: products, LayerNorm statistics,
aggregate and sums.  ``chip_smoke.py`` holds each float32 kernel's error
against this chain to ``chip_smoke.F64_RATIO`` times the float32 plain
version's.
On the CPU:

- float64 K1 against the JAX package's float32 kernel (interpret mode) and
  the port's float32 plain version: rtol = atol = 1e-5, float32's
  tolerance (the float32 sides round where float64 does not).  The masked
  edges' own e2 is not compared against JAX (its padding sentinel gathers
  zero rows for them, see test_torch_port_kernel.py).
- float64 K2 and K3 against the float32 plain versions on the same
  forward: rtol 1e-4 and atol 1e-4 of each output's largest element
  (``BWD_TOL["float32"]``); every output float64, a1/a2 the forward's.
- The float32 plain version's largest error against float64 lies below
  1e-5 of the largest element and above 0.
- ``chip_smoke.hold_to_f64`` passes a kernel whose error is up to
  F64_RATIO times the plain version's and refuses one above it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hyper_graph_nets_tpu.ops.pallas.fused_block import build_band_plan
from hyper_graph_nets_tpu.ops.pallas.fused_block import fused_edge_block as jax_fused_edge_block
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    agg_cotangent_rhs,
    fused_edge_block_bwd_reference,
    fused_edge_block_bwd_stream_reference,
    fused_edge_block_reference,
)
from torch_port_cases import interior_mask_case, long_segment_case, masked_edge_case, tie_edge_case

CASES = ("masked", "long_segments", "ties", "interior")


def _case(name, L=32):
    """(arrays, weights, senders, receivers, mask or None, N, valid prefix)."""
    if name == "masked":
        arrays, weights, snd, rcv, mask, N, nv = masked_edge_case(seed=3, L=L)
        return arrays, weights, snd, rcv, mask, N, nv
    if name == "ties":
        arrays, weights, snd, rcv, mask, N, _ = tie_edge_case(seed=3, L=L)
        return arrays, weights, snd, rcv, None, N, len(snd)
    if name == "interior":
        arrays, weights, snd, rcv, mask, N = interior_mask_case(seed=3, L=L)
        return arrays, weights, snd, rcv, mask, N, len(snd)
    arrays, weights, snd, rcv, mask, N = long_segment_case(seed=3, L=L)
    return arrays, weights, snd, rcv, None, N, len(snd)


def _inputs(name, dtype, L=32):
    arrays, weights, snd, rcv, mask, N, nv = _case(name, L)
    t = {k: torch.tensor(v).to(dtype) for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v) for k, v in weights.items()}
    topo = (torch.tensor(snd), torch.tensor(rcv), None if mask is None else torch.tensor(mask), N)
    return t, w, topo, nv


@pytest.mark.parametrize("case", CASES)
def test_k1_float64_chain_matches_jax_and_the_float32_plain_version(case):
    arrays, weights, snd, rcv, mask, N, nv = _case(case)
    t64, w, topo, _ = _inputs(case, torch.float64)
    e2, agg = fused_edge_block_reference(t64["e"], t64["sp"], t64["rp"], w, *topo)
    assert e2.dtype == torch.float64 and agg.dtype == torch.float64
    plan = build_band_plan(snd, rcv, N, num_valid=nv if case == "masked" else None, chunk=128)
    if case == "interior":  # the JAX kernel ignores interior masks (ROADMAP section 3): its plain function
        plan = None
    if plan is not None:
        je2, jagg = jax_fused_edge_block(
            *(jnp.asarray(arrays[k]) for k in ("e", "sp", "rp")),
            {k: jnp.asarray(v) for k, v in weights.items()}, plan, N, interpret=True,
        )
        np.testing.assert_allclose(e2.numpy()[:, :nv], np.asarray(je2)[:, :nv], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-5, atol=1e-5)
    t32 = {k: v.float() for k, v in t64.items()}
    e2_32, agg_32 = fused_edge_block_reference(t32["e"], t32["sp"], t32["rp"], w, *topo)
    torch.testing.assert_close(e2_32.double(), e2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(agg_32.double(), agg, rtol=1e-5, atol=1e-5)
    err = float((e2_32.double() - e2).abs().max())
    assert 0 < err <= 1e-5 * float(e2.abs().max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("L", [32, 128])
def test_k2_k3_float64_chain_match_the_float32_plain_versions(case, L):
    t32, w, topo, _ = _inputs(case, torch.float32, L)
    e2, agg, a1, a2, mu, isg = fused_edge_block_reference(
        t32["e"], t32["sp"], t32["rp"], w, *topo, save_streams=True)
    gen = torch.Generator().manual_seed(7)
    de2 = torch.randn(e2.shape, generator=gen)
    dagg = torch.randn(agg.shape, generator=gen)
    drhs = agg_cotangent_rhs(agg, dagg, topo[1], topo[2], topo[3])
    t64 = {k: v.double() for k, v in t32.items()}
    fwd = (e2, a1, a2)
    want = fused_edge_block_bwd_reference(t32["e"], t32["sp"], t32["rp"], w, de2, drhs, *topo, forward=fwd)
    got = fused_edge_block_bwd_reference(t64["e"], t64["sp"], t64["rp"], w, de2.double(), drhs, *topo, forward=fwd)
    assert all(g.dtype == torch.float64 for g in got)
    assert torch.equal(got[4], a1.double()) and torch.equal(got[5], a2.double())
    want3 = fused_edge_block_bwd_stream_reference(t32["e"], a1, a2, mu, isg, w, de2, drhs, *topo, e2=e2)
    got3 = fused_edge_block_bwd_stream_reference(
        t64["e"], a1.double(), a2.double(), mu, isg, w, de2.double(), drhs, *topo, e2=e2.double())
    pairs = list(zip(got[:4] + got[6:8], want[:4] + want[6:8])) + list(zip(got3[:6], want3[:6]))
    for g, x in pairs:
        scale = float(g.abs().max())
        torch.testing.assert_close(x.double(), g, rtol=1e-4, atol=1e-4 * scale)
        assert float((x.double() - g).abs().max()) <= 1e-5 * scale
    for k in range(5):  # column sums
        for g, x in ((got[8], want[8]), (got3[6], want3[6])):
            assert float((x[k].double() - g[k]).norm()) <= 1e-4 * float(g[k].norm())


@pytest.mark.parametrize("ratio", [0.0, 1.0, chip_smoke.F64_RATIO, 1.01 * chip_smoke.F64_RATIO])
def test_hold_to_f64_allows_the_ratio_and_no_more(ratio):
    gen = torch.Generator().manual_seed(1)
    exact = torch.randn(64, 32, generator=gen, dtype=torch.float64)
    noise = torch.randn(64, 32, generator=gen, dtype=torch.float64)
    plain = exact + 1e-7 * noise
    got = exact + ratio * 1e-7 * noise
    if ratio <= chip_smoke.F64_RATIO:
        errs = chip_smoke.hold_to_f64("K", {"e2": (got, plain, exact)})
        assert errs["e2"][0] == pytest.approx(ratio * errs["e2"][1])
        assert "e2" in chip_smoke.f64_text(errs)
    else:
        with pytest.raises(AssertionError, match="e2"):
            chip_smoke.hold_to_f64("K", {"e2": (got, plain, exact)})
