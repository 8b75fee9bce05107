"""The port's network and serving path against the JAX package.

Same weights (JAX init, moved by ``convert.state_from_jax_numpy``), same
numpy inputs, flag topology on a 10x10 grid, latent 32, 2 message-passing
blocks, for the ``fused``, ``xla``, ``sorted`` and ``gather`` paths.  The
JAX side runs its Pallas kernels in interpret mode; the port runs on the
CPU, where its kernel wrappers take their plain versions.

Tolerances:
- float32: rtol = atol = 1e-4 on node latents and outputs (summation order
  and the order of the first-layer sum differ); positions after one step
  and a 3-step rollout within rtol = 1e-5, atol = 1e-6.
- bf16: per-block latents within atol = 2**-3 and rtol = 2**-5.  Both
  sides round to bf16 after every product, but XLA on the CPU may skip a
  rounding inside an elementwise chain (excess precision), so single
  elements differ by a bf16 unit in the last place, and the differences
  pass through the following blocks.  Serving in bf16 is compared on the
  predicted acceleration (position minus ``2*cur - prev``), within 5% of
  its largest magnitude.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hyper_graph_nets_tpu.core.graph import EdgeSet as JEdgeSet, Graph as JGraph
from hyper_graph_nets_tpu.data.preprocessing import add_targets as jax_add_targets
from hyper_graph_nets_tpu.data.synthetic import flag_trajectory as jax_flag_trajectory
from hyper_graph_nets_tpu.models.get_model import get_model as jax_get_model
from hyper_graph_nets_tpu.nn.blocks import GNNConfig as JGNNConfig
from hyper_graph_nets_tpu.nn.meshgraphnet import (
    network_activations as jax_network_activations,
    network_init as jax_network_init,
)
from hyper_graph_nets_tpu.ops.pallas.fused_block import build_band_plan
from hyper_graph_nets_tpu.serving import Predictor as JaxPredictor
from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph
from hyper_graph_nets_tpu_torch.nn.blocks import GNNConfig
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import network_activations
from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block, plan_segments
from hyper_graph_nets_tpu_torch.ops.segment_pna import sorted_plan
from hyper_graph_nets_tpu_torch.serving import Predictor
from torch_port_cases import flag_config, grid_edges

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    normalizers = {
        name: {f: np.asarray(getattr(ns, f)) for f in NORMALIZER_FIELDS}
        for name, ns in state.normalizers.items()
    }
    return params, normalizers


# -- (b) per-block activations ---------------------------------------------


def _cfg_kwargs(compute_dtype, agg_vjp):
    return dict(
        output_size=3,
        node_in_dim=5,
        edge_in_dims=(("mesh_edges", 7),),
        latent_size=32,
        num_layers=2,
        message_passing_steps=2,
        aggregation="pna",
        compute_dtype=compute_dtype,
        agg_vjp=agg_vjp,
    )


CASES = [
    ("float32", "fused"),
    ("float32", "xla"),
    ("bfloat16", "fused"),
    ("float32", "sorted"),
    ("bfloat16", "sorted"),
    ("float32", "gather"),
]


@pytest.mark.parametrize("dtype,agg_vjp", CASES)
def test_block_activations_match_jax(dtype, agg_vjp):
    cd = None if dtype == "float32" else dtype
    snd, rcv, N = grid_edges(10, 10)
    rng = np.random.default_rng(3)
    nodes = rng.normal(size=(N, 5)).astype(np.float32)
    edges = rng.normal(size=(len(snd), 7)).astype(np.float32)
    # the neighbour matrices every topology carries (gather and sorted read them)
    gather = dict(zip(("gather_idx", "gather_valid"), receivers_to_gather(rcv, N)))
    gather.update(zip(("snd_gather_idx", "snd_gather_valid"), receivers_to_gather(snd, N)))

    jcfg = JGNNConfig(**_cfg_kwargs(cd, agg_vjp))
    jparams = jax_network_init(jax.random.PRNGKey(0), jcfg)
    jgraph = JGraph(
        node_features=jnp.asarray(nodes),
        edge_sets={
            "mesh_edges": JEdgeSet(
                features=jnp.asarray(edges),
                senders=jnp.asarray(snd),
                receivers=jnp.asarray(rcv),
                band_plan=(
                    build_band_plan(snd, rcv, N, chunk=128) if agg_vjp == "fused" else None
                ),
                **{k: jnp.asarray(v) for k, v in gather.items()},
            )
        },
    )
    jout = jax_network_activations(jparams, jgraph, jcfg)

    state = state_from_jax_numpy(jax.tree.map(np.asarray, jparams), {})
    graph = Graph(
        node_features=torch.tensor(nodes),
        edge_sets={
            "mesh_edges": EdgeSet(
                features=torch.tensor(edges),
                senders=torch.tensor(snd),
                receivers=torch.tensor(rcv),
                plan=(
                    plan_segments(rcv, N) if agg_vjp == "fused"
                    else sorted_plan(rcv, N) if agg_vjp == "sorted" else None
                ),
                **{k: torch.tensor(v) for k, v in gather.items()},
            )
        },
    )
    with torch.no_grad():
        out = network_activations(state.params, graph, GNNConfig(**_cfg_kwargs(cd, agg_vjp)))

    rtol, atol = (1e-4, 1e-4) if dtype == "float32" else (2.0**-5, 2.0**-3)
    assert len(out["blocks"]) == len(jout["blocks"]) == 2
    for got, want in zip(out["blocks"], jout["blocks"]):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol
        )
    np.testing.assert_allclose(
        out["output"].numpy(), np.asarray(jout["output"]), rtol=rtol, atol=atol
    )


# -- (c) whole-slice parity through Predictor --------------------------------


def _trajectory():
    # 5 simulated steps -> 3 frames with prev/target after add_targets
    return jax_add_targets(jax_flag_trajectory(num_steps=5, nx=10, ny=10), "world_pos", True)


def _trained_normalizer_state(config, traj):
    """JAX state whose normalizers have seen the trajectory (real scale)."""
    model = jax_get_model(config)
    state = model.init_state(jax.random.PRNGKey(0))
    topo = model.build_topology(traj["cells"][0])
    frames = {k: jnp.asarray(v) for k, v in traj.items() if k != "cells"}
    _, _, state = model.make_graph(state, topo, frames, True)
    _, state = model.get_target(state, frames, True)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_one_step_matches_jax(dtype):
    config = flag_config(None if dtype == "float32" else dtype)
    traj = _trajectory()
    jstate = _trained_normalizer_state(config, traj)
    frames2 = {k: v[:2] for k, v in traj.items()}  # B = 2

    want = JaxPredictor(config, state=jstate).one_step(frames2)
    before = fused_edge_block.launches
    port = Predictor(config, state=state_from_jax_numpy(*_numpy_state(jstate)), device="cpu")
    got = port.one_step(frames2)
    assert fused_edge_block.launches == before
    assert got.shape == want.shape == (2, 100, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        base = 2 * frames2["world_pos"] - frames2["prev|world_pos"]
        acc_got, acc_want = got - base, want - base
        scale = np.abs(acc_want).max()
        assert np.abs(acc_got - acc_want).max() <= 0.05 * scale


def test_predictor_rollout_matches_jax():
    config = flag_config(None)
    traj = _trajectory()
    jstate = _trained_normalizer_state(config, traj)
    want = JaxPredictor(config, state=jstate).rollout(traj, num_steps=3)
    port = Predictor(config, state=state_from_jax_numpy(*_numpy_state(jstate)), device="cpu")
    got = port.rollout(traj, num_steps=3)
    assert set(got) == set(want)
    assert got["pred_pos"].shape == want["pred_pos"].shape == (3, 100, 3)
    np.testing.assert_allclose(got["pred_pos"], want["pred_pos"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4, atol=1e-9)
    for key in ("gt_pos", "faces", "mesh_pos"):
        np.testing.assert_array_equal(got[key], want[key])
