"""The port's CUDA kernel on the card (marker ``cuda``; skips without a card).

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

K1 is held against its plain PyTorch version on the same inputs (an
isolated receiver and a masked tail, or receivers whose edges span several
kernel tiles), and a small flag MeshGraphNets predictor is held against the
same state on the CPU.

Tolerances: float32 rtol = atol = 1e-5 (summation order).  bf16: e2 within
rtol = 2**-7, atol = 2**-5 and the aggregate within rtol = atol = 2**-5
(both sides round at the same points; an element differs only where a sum
in another order rounds the other way, by one bf16 unit in the last place);
the sum over a receiver's 150 edges within atol = 150 * 2**-5.
Predictor outputs (bf16, 2 blocks) within 5% of the largest |output|.
"""
import numpy as np
import pytest
import torch

from hyper_graph_nets_tpu_torch.data.preprocessing import add_targets
from hyper_graph_nets_tpu_torch.data.synthetic import flag_trajectory
from hyper_graph_nets_tpu_torch.ops.fused_block import (
    fused_edge_block,
    fused_edge_block_reference,
)
from hyper_graph_nets_tpu_torch.runtime import configure_numerics
from hyper_graph_nets_tpu_torch.serving import Predictor
from torch_port_cases import BF16_ULP, flag_config, long_segment_case, masked_edge_case

TOLS = {
    torch.float32: dict(e2=(1e-5, 1e-5), agg=(1e-5, 1e-5)),
    torch.bfloat16: dict(e2=(BF16_ULP, 4 * BF16_ULP), agg=(4 * BF16_ULP, 4 * BF16_ULP)),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    configure_numerics()


def _case(name, L):
    """(arrays, weights, senders, receivers, mask, N, an isolated receiver)."""
    if name == "masked":
        arrays, weights, snd, rcv, mask, N, _ = masked_edge_case(seed=2, B=3, L=L)
        return arrays, weights, snd, rcv, mask, N, 10
    arrays, weights, snd, rcv, mask, N = long_segment_case(seed=2, B=3, L=L)
    return arrays, weights, snd, rcv, mask, N, 9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize("case", ["masked", "long_segments"])
def test_k1_kernel_matches_plain(dtype, L, case):
    _need_card()
    arrays, weights, snd, rcv, mask, N, isolated = _case(case, L)
    t = {k: torch.tensor(v).to(dtype).cuda() for k, v in arrays.items()}
    w = {k: torch.tensor(v.T.copy() if v.ndim == 2 else v).cuda() for k, v in weights.items()}
    args = (torch.tensor(snd).cuda(), torch.tensor(rcv).cuda(), torch.tensor(mask).cuda(), N)
    before = fused_edge_block.launches
    e2, agg = fused_edge_block(t["e"], t["sp"], t["rp"], w, *args)
    torch.cuda.synchronize()
    assert fused_edge_block.launches == before + 1
    re2, ragg = fused_edge_block_reference(t["e"], t["sp"], t["rp"], w, *args)
    (er, ea), (gr, ga) = TOLS[dtype]["e2"], TOLS[dtype]["agg"]
    torch.testing.assert_close(e2.float(), re2.float(), rtol=er, atol=ea)
    # in bf16 each of a long segment's 150 summands may differ by one
    # rounding of e2, so the sum's atol grows with the count
    L = e2.shape[-1]
    sum_atol = ga * 150 if (case == "long_segments" and dtype == torch.bfloat16) else ga
    torch.testing.assert_close(agg[..., L:], ragg[..., L:], rtol=gr, atol=ga)
    torch.testing.assert_close(agg[..., :L], ragg[..., :L], rtol=gr, atol=sum_atol)
    assert bool((agg[:, isolated] == 0).all())


@pytest.mark.cuda
def test_predictor_on_card_matches_cpu():
    _need_card()
    config = flag_config("bfloat16")
    traj = add_targets(flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)
    card = Predictor(config)
    cpu = Predictor(config, state=card.state, device="cpu")
    before = fused_edge_block.launches
    got = card.one_step(traj)
    assert fused_edge_block.launches == before + 2  # one per block
    want = cpu.one_step(traj)
    assert np.isfinite(got).all()
    base = 2 * traj["world_pos"] - traj["prev|world_pos"]
    scale = np.abs(want - base).max()
    assert np.abs(got - want).max() <= 0.05 * scale
