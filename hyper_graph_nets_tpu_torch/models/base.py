"""System-model base: state containers and the shared model protocol.

Counterpart of ``hyper_graph_nets_tpu/models/base.py``.  A model is a
static-config object whose methods are functions of an explicit
:class:`ModelState` (network + normalizer states).  Topology is extracted
once per trajectory on the host and moved to the model's device.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import warnings
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import normalizer as norm
from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph, NodeType
from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges, receivers_to_gather
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums
from hyper_graph_nets_tpu_torch.nn.blocks import GNNConfig
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import (
    MeshGraphNet,
    network_apply,
    network_init,
)
from hyper_graph_nets_tpu_torch.nn.quant import quantize_network
from hyper_graph_nets_tpu_torch.ops import reorder
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan, plan_segments
from hyper_graph_nets_tpu_torch.ops.segment_pna import SortedPlan, sorted_plan


@dataclasses.dataclass(frozen=True)
class ModelState:
    """Network parameters plus normalizer states."""

    params: MeshGraphNet
    normalizers: Dict[str, norm.NormalizerState]

    def replace(self, **changes) -> "ModelState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ModelState":
        """A copy on ``device``; this state is left where it is."""
        return ModelState(
            params=copy.deepcopy(self.params).to(device),
            normalizers={k: v.to(device) for k, v in self.normalizers.items()},
        )


class Topology(NamedTuple):
    """Per-trajectory mesh topology on the model's device.

    ``mask`` is None when every edge is valid; ``plan`` is the kernel plan
    of ``agg_vjp``: the fused kernels' :class:`SegmentPlan` under ``fused``
    (only where the JAX package builds its band plan: the numbering passes
    ``ops.reorder.check_banded``; otherwise the set runs unfused, as there),
    the sorted pna kernels' :class:`SortedPlan` under ``sorted``, else None.
    The receiver and sender neighbour matrices (``receivers_to_gather``) are
    built for every topology, as in the JAX package (``models/base.py:
    402-416``), and so are the fixed-order sums (``sums``) of the unfused
    paths.  ``aux`` holds a model's own per-trajectory arrays (plate's
    obstacle indices) and ``world_cap`` plate's world-edge capacity under
    ``max_world_edges: auto``, as in the JAX package.  ``layout`` is set on
    a topology split over a rank group's edge shards
    (``parallel.sharding.shard_topology``): how its edges lie there
    (``parallel.sharding.EdgeLayout``).
    """

    senders: torch.Tensor  # [E] int32, sorted by receiver
    receivers: torch.Tensor  # [E] int32
    num_nodes: int
    mask: Optional[torch.Tensor] = None  # [E] float32
    plan: Optional[Union[SegmentPlan, SortedPlan]] = None
    gather_idx: Optional[torch.Tensor] = None  # [N, d_max] int32
    gather_valid: Optional[torch.Tensor] = None  # [N, d_max] float32
    snd_gather_idx: Optional[torch.Tensor] = None
    snd_gather_valid: Optional[torch.Tensor] = None
    sums: Optional[EdgeSums] = None
    aux: Optional[Dict[str, torch.Tensor]] = None
    world_cap: Optional[int] = None
    layout: Optional[object] = None


def mesh_edge_set(topo: Topology, features: torch.Tensor) -> EdgeSet:
    """The ``mesh_edges`` set of a topology with its plan, neighbour
    matrices and fixed-order sums."""
    return EdgeSet(
        features=features,
        senders=topo.senders,
        receivers=topo.receivers,
        mask=topo.mask,
        plan=topo.plan,
        gather_idx=topo.gather_idx,
        gather_valid=topo.gather_valid,
        snd_gather_idx=topo.snd_gather_idx,
        snd_gather_valid=topo.snd_gather_valid,
        sums=topo.sums,
    )


def reset_due(step: int, num_steps: int, frequency: int) -> bool:
    """Whether an expansion's cache resets at ``step`` of ``num_steps``:
    ``frequency`` times over the run (every call at frequency 1 and step 0,
    as ``Predictor`` asks)."""
    return step % math.ceil(num_steps / frequency) == 0


def one_hot(codes: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros for a code outside ``[0, num_classes)``
    (a padded node's negative type)."""
    return (codes[..., None] == torch.arange(num_classes, device=codes.device)).to(dtype)


def norm_feature(rel: torch.Tensor) -> torch.Tensor:
    """``[rel, ||rel||]`` feature block used by every edge featurizer."""
    return torch.cat([rel, torch.sqrt((rel * rel).sum(dim=-1, keepdim=True))], dim=-1)


class SystemModel:
    """Static configuration shared by all datasets."""

    model_type = "flag"

    def __init__(self, params: dict):
        self.params = params
        model = params["model"]
        rmp_cfg = model.get("rmp", {})
        bal_cfg = model.get("graph_balancer", {})
        self.field = model["field"]
        self.output_size = model["size"]
        self.noise_scale = model.get("noise")
        self.noise_gamma = model.get("gamma", 1.0)
        self.message_passing_steps = model["message_passing_steps"]
        self.aggregation = model.get("aggregation", "pna")
        self.latent_size = model.get("latent_size", 128)
        self.num_layers = model.get("num_layers", 2)
        self.compute_dtype = model.get("compute_dtype")
        self.use_rmp = (
            rmp_cfg.get("clustering", "none") != "none"
            and rmp_cfg.get("connector", "none") != "none"
        )
        self.architecture = rmp_cfg.get("connector", "none") if self.use_rmp else "none"
        if not self.use_rmp and rmp_cfg.get("connector") == "repeated":
            self.architecture = "repeated"
        self.use_balancer = bal_cfg.get("algorithm", "none") != "none"
        self.rmp_frequency = rmp_cfg.get("frequency", 1)
        self.balance_frequency = bal_cfg.get("frequency", 1)
        self.rmp_config = rmp_cfg
        if model.get("agg_vjp") == "fused" and self.aggregation != "pna":
            warnings.warn(
                f"model.agg_vjp 'fused' needs aggregation 'pna'; with {self.aggregation!r} no "
                "edge set runs the fused kernels (K1/K2): every set takes the unfused path",
                stacklevel=2,
            )
        # host-side eval counters that rollout and n-step computations add
        # to; the simulator's evaluators drain them (pop_eval_metrics)
        self.eval_metrics: Dict[str, float] = {}

    def pop_eval_metrics(self) -> Dict[str, float]:
        """Drain the accumulated eval counters (see ``eval_metrics``)."""
        out, self.eval_metrics = self.eval_metrics, {}
        return out

    def n_step_chunk_size(self, num_windows: int) -> int:
        """Windows per batched forward (config ``model.n_step_chunk``, 32)."""
        cfg = int(self.params["model"].get("n_step_chunk", 32))
        return max(1, min(cfg, num_windows))

    @staticmethod
    def _n_step_chunked(window_losses, starts: np.ndarray, chunk: int) -> Tuple[float, float]:
        """Run n-step windows ``chunk`` at a time (the last chunk may be
        short) and return (mean over windows of each window's mean loss,
        mean over windows of its last-step loss): the JAX package's
        ``_n_step_chunked``.  ``window_losses(starts)`` returns the
        per-window, per-step losses ``[len(starts), n + 1]``; the sums stay
        on the device until the end."""
        W = len(starts)
        if W == 0:
            return float("nan"), float("nan")
        mean_sum = last_sum = 0.0
        for s0 in range(0, W, chunk):
            losses = window_losses(starts[s0 : s0 + chunk])
            mean_sum = mean_sum + losses.mean(dim=1).sum()
            last_sum = last_sum + losses[:, -1].sum()
        return float(mean_sum) / W, float(last_sum) / W

    # -- schema hooks (subclasses override) --------------------------------
    def edge_in_dims(self) -> Tuple[Tuple[str, int], ...]:
        raise NotImplementedError

    def node_in_dim(self) -> int:
        raise NotImplementedError

    def hyper_in_dim(self) -> Optional[int]:
        """Raw hyper node width: the node features' cluster means, and
        ``[size, mesh spread, world spread]`` with ``hyper_node_features``."""
        if not self.use_rmp:
            return None
        extra = 3 if self.rmp_config.get("hyper_node_features", True) else 0
        return self.node_in_dim() + extra

    def normalizer_schema(self) -> Dict[str, int]:
        raise NotImplementedError

    # -- construction ------------------------------------------------------
    @functools.cached_property
    def gnn_config(self) -> GNNConfig:
        return GNNConfig(
            output_size=self.output_size,
            node_in_dim=self.node_in_dim(),
            edge_in_dims=self.edge_in_dims(),
            latent_size=self.latent_size,
            num_layers=self.num_layers,
            message_passing_steps=self.message_passing_steps,
            aggregation=self.aggregation,
            architecture=self.architecture,
            hyper_in_dim=self.hyper_in_dim(),
            compute_dtype=self.compute_dtype,
            agg_vjp=self.params["model"].get("agg_vjp", "xla"),
            fused_bwd=self.params["model"].get("fused_bwd", "remat"),
            fused_fwd=self.params["model"].get("fused_fwd", "kernel"),
            fused_pb=int(self.params["model"].get("fused_pb", 1)),
            fused_pb_bwd=int(self.params["model"].get("fused_pb_bwd", 1)),
            remat=bool(self.params["model"].get("remat", False)),
        )

    def init_state(self, generator: Optional[torch.Generator] = None) -> ModelState:
        """Random network and empty normalizers, on the CPU."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = network_init(generator, self.gnn_config)
        normalizers = {
            name: norm.init(size) for name, size in self.normalizer_schema().items()
        }
        return ModelState(params=params, normalizers=normalizers)

    def build_topology(
        self,
        cells: np.ndarray,
        num_nodes: Optional[int] = None,
        deform: bool = False,
        device="cpu",
    ) -> Topology:
        """Host: cells -> receiver-sorted topology on ``device``."""
        edges = cells_to_edges(np.asarray(cells), deform=deform)
        if num_nodes is None:
            num_nodes = int(np.asarray(cells).max()) + 1
        return self.topology_from_edges(edges.senders, edges.receivers, num_nodes, device=device)

    def topology_from_edges(
        self, senders, receivers, num_nodes: int, device="cpu", mask=None, banded: Optional[bool] = None
    ) -> Topology:
        """Host: a receiver-sorted edge list -> topology on ``device``, with
        the kernel plan of ``agg_vjp``, the neighbour matrices and the
        fixed-order sums.

        ``mask`` (``[E]``, a bucketed topology's, ``data.bucketing``) holds
        the valid edges first and a masked tail after them: the K1/K2 plan
        takes the tail as receiver-less work items (``num_valid``), and the
        sorted plan, the neighbour matrices and the sums leave it out.
        ``banded`` overrides the band criterion's decision for the fused
        path (a bucket's, ``data.bucketing.pad_topology``)."""
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        num_valid = None
        if mask is not None:
            mask = np.asarray(mask, np.float32)
            num_valid = int((mask > 0).sum())
            if not (mask[:num_valid] > 0).all():
                raise ValueError("a topology's mask must hold its valid edges first and the masked ones after")
        plan = None
        if self.gnn_config.agg_vjp == "fused":
            if banded is None:
                chunk = self.params["model"].get("fused_chunk")
                banded = reorder.check_banded(senders, receivers, num_valid=num_valid, chunk=chunk)
            if banded:
                plan = plan_segments(receivers, num_nodes, senders=senders, num_valid=num_valid).to(device)
            elif torch.device(device).type != "cpu":
                warnings.warn(
                    "agg_vjp 'fused': the mesh numbering fails the band criterion "
                    "(ops.reorder.check_banded), so its edge sets run unfused, without "
                    "K1/K2; relabel it (ops.reorder.reorder_trajectory) to fuse them",
                    stacklevel=2,
                )
        elif self.gnn_config.agg_vjp == "sorted":
            plan = sorted_plan(receivers, num_nodes, mask=mask).to(device)
        gidx, gvalid = receivers_to_gather(receivers, num_nodes, mask=mask)
        sidx, svalid = receivers_to_gather(senders, num_nodes, mask=mask)
        dev = lambda a: torch.from_numpy(a).to(device)
        return Topology(
            senders=dev(senders),
            receivers=dev(receivers),
            num_nodes=num_nodes,
            mask=None if mask is None else dev(mask),
            plan=plan,
            gather_idx=dev(gidx),
            gather_valid=dev(gvalid),
            snd_gather_idx=dev(sidx),
            snd_gather_valid=dev(svalid),
            sums=EdgeSums.build(senders, receivers, num_nodes, mask=mask).to(device),
        )

    def topology_from_trajectory(
        self, trajectory: Dict[str, np.ndarray], device="cpu"
    ) -> Topology:
        return self.build_topology(
            trajectory["cells"][0],
            num_nodes=int(trajectory["node_type"].shape[1]),
            device=device,
        )

    def topology_content_key(self, trajectory: Dict[str, np.ndarray]) -> tuple:
        """Extra cache-key content beyond the mesh connectivity (none here;
        plate's world-edge capacity under ``max_world_edges: auto``)."""
        return ()

    def bucket_topology_extras(self, trajectories) -> Optional[dict]:
        """Bucket-level dims of a model's topology aux (none here)."""
        return None

    def pad_topology_aux(self, trajectory, num_nodes: int, extras: Optional[dict]):
        """``(aux, world_cap)`` of a bucketed topology (none here)."""
        return None, None

    def forward(self, state: ModelState, graph: Graph) -> torch.Tensor:
        return network_apply(state.params, graph, self.gnn_config)

    def predict(self, state: ModelState, topo: Topology, frame, expansion=None, static=None):
        """``(update, make_graph's aux)`` of one frame or a batch of frames,
        the graph expanded (with ``static``) when an expansion is given: the
        step every rollout and n-step loop takes."""
        graph, aux, _ = self.make_graph(state, topo, frame, False)
        if expansion is not None:
            graph, _ = expansion.expand(state, graph, frame, self, is_training=False, static=static)
        return self.update(state, frame, self.forward(state, graph)), aux

    def inference_state(self, state: ModelState) -> ModelState:
        """State for inference, honouring ``model.inference_quant``: with
        ``int8`` a new state whose every MLP weight is per-channel int8
        (``nn/quant.py``; the forward then runs W8A8 products), ``state``
        itself left float; anything else returns ``state`` unchanged."""
        if self.params["model"].get("inference_quant") != "int8":
            return state
        return state.replace(params=quantize_network(state.params))

    # -- shared helpers ----------------------------------------------------
    def _normalize(
        self,
        state: ModelState,
        name: str,
        data: torch.Tensor,
        accumulate: bool,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ModelState]:
        out, ns = norm.normalize(
            state.normalizers[name], data, accumulate_stats=accumulate, mask=mask
        )
        normalizers = dict(state.normalizers)
        normalizers[name] = ns
        return out, state.replace(normalizers=normalizers)

    def loss_mask(self, node_type: torch.Tensor) -> torch.Tensor:
        """Rows contributing to the loss (flag: NORMAL nodes)."""
        return node_type[..., 0] == NodeType.NORMAL

    # -- geometry and clustering hooks ---------------------------------------
    def geometry(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(target_feature, mesh_features)``: the world and mesh coordinate
        streams of the frames."""
        raise NotImplementedError

    def obstacle_mask_np(self, frame: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Nodes left out of the clustering (plate's obstacles); None here."""
        return None

    def world_edge_receiver_nodes(self, frame: Dict[str, np.ndarray], topo: Topology) -> Optional[np.ndarray]:
        """Nodes receiving world edges in ``frame`` (models with world edges)."""
        return None

    def host_graph(self, frame: Dict[str, np.ndarray], topo: Topology):
        """Numpy snapshot of one frame for the host-side clustering: the
        coordinate streams, the valid mesh edges with their unnormalized
        features, and each node's max - min incident ``|rel_world|``."""
        from hyper_graph_nets_tpu_torch.rmp.clustering import HostGraph

        host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        target, mesh = (np.asarray(a) for a in self.geometry({k: host(v) for k, v in frame.items()}))
        snd, rcv = host(topo.senders), host(topo.receivers)
        if topo.mask is not None:
            valid = host(topo.mask) > 0
            snd, rcv = snd[valid], rcv[valid]
        rel_t = target[snd] - target[rcv]
        rel_m = mesh[snd] - mesh[rcv]
        tn = np.linalg.norm(rel_t, axis=-1, keepdims=True)
        ef = np.concatenate([rel_t, tn, rel_m, np.linalg.norm(rel_m, axis=-1, keepdims=True)], axis=-1)
        dyn_max = np.full(topo.num_nodes, -np.inf)
        dyn_min = np.full(topo.num_nodes, np.inf)
        np.maximum.at(dyn_max, rcv, tn[:, 0])
        np.minimum.at(dyn_min, rcv, tn[:, 0])
        dyn = np.where(np.isfinite(dyn_max) & np.isfinite(dyn_min), dyn_max - dyn_min, 0.0)
        obstacle = self.obstacle_mask_np(frame)
        # padded nodes (node_type < 0) are left out like obstacles
        padded = host(frame["node_type"])[:, 0] < 0
        if padded.any():
            obstacle = padded if obstacle is None else (obstacle | padded)
        return HostGraph(
            target_feature=target,
            mesh_features=mesh,
            senders=snd,
            receivers=rcv,
            edge_features=ef,
            node_dynamic=dyn,
            obstacle_mask=obstacle,
            world_dim=target.shape[-1],
        )
