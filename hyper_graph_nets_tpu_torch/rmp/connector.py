"""Connectors: hyper nodes and remote edge sets from a clustering.

Counterpart of ``hyper_graph_nets_tpu/rmp/connector.py``, in two stages:

- the host stage (:func:`build_static`, numpy and scipy) turns a clustering
  into the static incidence of :class:`RMPStatic`, kept until the next
  recluster;
- the device stage (:meth:`HierarchicalConnector.expand`, torch) computes
  the hyper node features and the remote edge features of the current
  frames: cluster means as one ``[K, N]`` product with the assignment
  matrix, intra-cluster edges as each node's difference to its cluster's
  mean.

Edge features are ``[rel_world, |rel_world|, rel_mesh, |rel_mesh|]`` split at
the model's world dimension, as in the JAX package.  Hyper node features are
the cluster means of the normalized node features, with ``[size, mesh
spread, world spread]`` through the ``hyper_node`` normalizer
(``hyper_node_features``).  :meth:`~HierarchicalConnector.expand` returns
the new normalizer states; it never updates one in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph
from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges, receivers_to_gather
from hyper_graph_nets_tpu_torch.rmp.clustering import Clustering


class RMPStatic(NamedTuple):
    """Static incidence of one clustering: numpy from :func:`build_static`,
    tensors after :meth:`to`.

    The port adds to the JAX package's fields the fixed-order sums of the
    three cluster-tier sets (``core.segment_ops.EdgeSums`` over ``N + K``
    rows) and ``mesh_plan``, the mesh set's fused-kernel plan over
    ``N + K`` rows (None unless the topology carries a
    ``ops.fused_block.SegmentPlan``) and, with ``rmp.fused_tiers``, the
    cluster-tier sets' plans; ``RemoteMessagePassing.prepare`` attaches
    them.
    """

    labels: np.ndarray  # [N] int32, clamped >= 0
    member_mask: np.ndarray  # [N] f32 (sampled membership)
    assign_mean: np.ndarray  # [K, N] f32 rows sum to 1 over members
    sizes: np.ndarray  # [K] f32 cluster sizes
    # up: member -> hyper (intra_cluster_to_cluster), receiver-sorted with
    # non-members (mask 0) at the tail
    up_perm: np.ndarray  # [N] node order
    up_senders: np.ndarray  # [N]
    up_receivers: np.ndarray  # [N] (N + label)
    up_mask: np.ndarray  # [N]
    up_gather: Tuple[np.ndarray, np.ndarray]  # [(N+K, d), ...]
    # down: hyper -> member (intra_cluster_to_mesh), members ascending,
    # non-members at the tail
    down_perm: np.ndarray  # [N]
    down_senders: np.ndarray  # [N]
    down_receivers: np.ndarray  # [N]
    down_mask: np.ndarray  # [N]
    down_gather: Tuple[np.ndarray, np.ndarray]
    # inter: hyper -> hyper, padded to K*(K-1)
    inter_senders: np.ndarray  # [P]
    inter_receivers: np.ndarray  # [P]
    inter_mask: np.ndarray  # [P]
    inter_gather: Tuple[np.ndarray, np.ndarray]
    # per-cluster member lists for the spreads
    member_idx: np.ndarray  # [K, m_max]
    member_valid: np.ndarray  # [K, m_max]
    # world-aware inter edges between clusters whose members receive world
    # edges (rmp.inter_cluster_world, plate); None otherwise
    inter_world_senders: Optional[np.ndarray] = None
    inter_world_receivers: Optional[np.ndarray] = None
    inter_world_mask: Optional[np.ndarray] = None
    # attached by RemoteMessagePassing.prepare
    up_sums: Optional[object] = None
    down_sums: Optional[object] = None
    inter_sums: Optional[object] = None
    inter_world_sums: Optional[object] = None
    merged_sums: Optional[object] = None  # MultigraphConnector's merged mesh_edges
    mesh_plan: Optional[object] = None
    # with rmp.fused_tiers: each cluster-tier set's K1/K2 plan over its
    # valid prefix, None for a set that stays unfused
    up_plan: Optional[object] = None
    down_plan: Optional[object] = None
    inter_plan: Optional[object] = None
    inter_world_plan: Optional[object] = None

    @property
    def num_clusters(self) -> int:
        return int(self.assign_mean.shape[0])

    def to(self, device) -> "RMPStatic":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(move(v) for v in x)
            if isinstance(x, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)
            return x.to(device)

        return RMPStatic(*(move(x) for x in self))


def _delaunay_pairs(centers: np.ndarray) -> list:
    """Inter-cluster pairs from a Delaunay triangulation of the first two
    coordinates of the cluster centers (the triangles' edges)."""
    import scipy.spatial as ss

    if len(centers) < 3:
        return [(a, b) for a in range(len(centers)) for b in range(len(centers)) if a != b]
    tri = ss.Delaunay(centers[:, :2])
    edges = cells_to_edges(tri.simplices.astype(np.int32))
    return list(zip(edges.unique_senders.tolist(), edges.unique_receivers.tolist()))


def build_static(
    clustering: Clustering,
    num_nodes: int,
    fully_connect: bool = False,
    inter_mode: str = "neighbors",
    cluster_centers: Optional[np.ndarray] = None,
    inter_world: bool = False,
    world_collide_labels: Optional[np.ndarray] = None,
) -> RMPStatic:
    """Host stage: clustering -> static incidence arrays (numpy).

    ``inter_mode``: ``neighbors`` (clusters joined by a mesh edge) or
    ``delaunay`` (triangulated cluster centers).  Fewer than 4 clusters, or
    ``fully_connect``, join every pair.
    """
    K = clustering.num_clusters
    labels = np.zeros(num_nodes, np.int32)
    member_mask = np.zeros(num_nodes, np.float32)
    # sampled clusters may overlap; the last listed cluster wins
    for c, members in enumerate(clustering.clusters):
        labels[members] = c
        member_mask[members] = 1.0
    full = np.asarray(clustering.labels)
    keep = (full >= 0) & (member_mask == 0)
    labels[keep] = full[keep]

    assign = np.zeros((K, num_nodes), np.float32)
    assign[labels, np.arange(num_nodes)] = member_mask
    sizes = assign.sum(axis=1)
    assign_mean = assign / np.maximum(sizes, 1.0)[:, None]

    up_perm = np.lexsort((np.arange(num_nodes), labels, member_mask == 0)).astype(np.int32)
    up_senders = up_perm
    up_receivers = (num_nodes + labels[up_perm]).astype(np.int32)
    up_mask = member_mask[up_perm]
    up_gather = receivers_to_gather(up_receivers, num_nodes + K, mask=up_mask)

    down_perm = np.lexsort((np.arange(num_nodes), member_mask == 0)).astype(np.int32)
    down_senders = (num_nodes + labels[down_perm]).astype(np.int32)
    down_receivers = down_perm.copy()
    down_mask = member_mask[down_perm]
    down_gather = receivers_to_gather(down_receivers, num_nodes + K, mask=down_mask)

    P = max(K * (K - 1), 1)
    inter_s = np.zeros(P, np.int32)
    inter_r = np.zeros(P, np.int32)
    inter_m = np.zeros(P, np.float32)
    if fully_connect or K < 4:
        pairs = [(a, b) for a in range(K) for b in range(K) if a != b]
    elif inter_mode == "delaunay" and cluster_centers is not None:
        pairs = []
        for a, b in _delaunay_pairs(cluster_centers):
            pairs += [(a, b), (b, a)]
    else:
        pairs = []
        for a, b in clustering.neighbors:
            if a != b:
                pairs += [(a, b), (b, a)]
    pairs = sorted(set(pairs), key=lambda p: (p[1], p[0]))[:P]
    for i, (a, b) in enumerate(pairs):
        inter_s[i] = num_nodes + a
        inter_r[i] = num_nodes + b
        inter_m[i] = 1.0
    inter_gather = receivers_to_gather(inter_r, num_nodes + K, mask=inter_m)

    m_max = max(int(sizes.max(initial=1)), 1)
    member_idx = np.zeros((K, m_max), np.int32)
    member_valid = np.zeros((K, m_max), np.float32)
    cursor = np.zeros(K, np.int32)
    for i in range(num_nodes):
        if member_mask[i] > 0:
            c = labels[i]
            member_idx[c, cursor[c]] = i
            member_valid[c, cursor[c]] = 1.0
            cursor[c] += 1

    iw_s = iw_r = iw_m = None
    if inter_world:
        iw_s = np.zeros(P, np.int32)
        iw_r = np.zeros(P, np.int32)
        iw_m = np.zeros(P, np.float32)
        if world_collide_labels is not None and len(world_collide_labels):
            collide = sorted({int(l) for l in np.asarray(world_collide_labels) if 0 <= l < K})
            w_pairs = sorted(
                ((a, b) for a in collide for b in collide if a != b), key=lambda p: (p[1], p[0])
            )[:P]
            for i, (a, b) in enumerate(w_pairs):
                iw_s[i] = num_nodes + a
                iw_r[i] = num_nodes + b
                iw_m[i] = 1.0

    return RMPStatic(
        labels=labels,
        member_mask=member_mask,
        assign_mean=assign_mean,
        sizes=sizes.astype(np.float32),
        up_perm=up_perm,
        up_senders=up_senders,
        up_receivers=up_receivers,
        up_mask=up_mask.astype(np.float32),
        up_gather=up_gather,
        down_perm=down_perm,
        down_senders=down_senders,
        down_receivers=down_receivers,
        down_mask=down_mask.astype(np.float32),
        down_gather=down_gather,
        inter_senders=inter_s,
        inter_receivers=inter_r,
        inter_mask=inter_m,
        inter_gather=inter_gather,
        member_idx=member_idx,
        member_valid=member_valid,
        inter_world_senders=iw_s,
        inter_world_receivers=iw_r,
        inter_world_mask=iw_m,
    )


def _norm_feature(rel: torch.Tensor) -> torch.Tensor:
    return torch.cat([rel, torch.sqrt((rel * rel).sum(dim=-1, keepdim=True))], dim=-1)


def _edge_feats(rel: torch.Tensor, world_dim: int) -> torch.Tensor:
    """``[rel_world, |rel_world|, rel_mesh, |rel_mesh|]`` split at ``world_dim``."""
    return torch.cat(
        [_norm_feature(rel[..., :world_dim]), _norm_feature(rel[..., world_dim:])], dim=-1
    )


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(x.dim() - 2, idx.long())


def _pad_rows(t: Optional[torch.Tensor], extra: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))], dim=0)


class HierarchicalConnector:
    """Two-tier hypergraph connector: ``intra_cluster_to_cluster`` (up),
    ``inter_cluster`` and ``intra_cluster_to_mesh`` (down) edge sets and a
    hyper node per cluster."""

    name = "hyper"
    edge_set_names = ("intra_cluster_to_mesh", "intra_cluster_to_cluster", "inter_cluster")

    def __init__(
        self,
        fully_connect: bool = False,
        noise_scale: Optional[float] = None,
        hyper_node_features: bool = True,
        inter_mode: str = "neighbors",
        inter_world: bool = False,
    ):
        self.fully_connect = fully_connect
        self.noise_scale = None if noise_scale in (None, "none") else noise_scale
        self.hyper_node_features = hyper_node_features
        self.inter_mode = inter_mode
        self.inter_world = inter_world

    def initialize(self) -> list:
        names = list(self.edge_set_names)
        if self.inter_world:
            names.append("inter_cluster_world")
        return names

    def expand(
        self,
        state,
        graph: Graph,
        static: RMPStatic,
        target_feature: torch.Tensor,  # [..., N, Dw]
        mesh_features: torch.Tensor,  # [..., N, Dm]
        model,
        is_training: bool,
        normal: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Device stage: add the hyper tier and the remote edge sets to
        ``graph`` (batched or not; the static is shared by the batch).
        In training with ``hyper_noise`` the cluster means get
        ``hyper_noise * normal``, a standard-normal draw of the means' shape
        (drawn from ``generator`` when omitted).  Returns ``(graph, new
        model state)``."""
        world_dim = target_feature.shape[-1]
        coords = torch.cat([target_feature, mesh_features], dim=-1).to(torch.float32)
        assign = static.assign_mean
        means = torch.einsum("kn,...nd->...kd", assign, coords)
        if is_training and self.noise_scale is not None:
            if normal is None:
                normal = torch.randn(
                    means.shape, generator=generator, device=means.device, dtype=means.dtype
                )
            means = means + self.noise_scale * normal.to(means)
        node_feature_means = torch.einsum("kn,...nf->...kf", assign, graph.node_features)

        diff = coords - _rows(means, static.labels)  # each node to its cluster's mean
        K = static.num_clusters
        if self.hyper_node_features:
            d_world = torch.sqrt(diff[..., :world_dim].square().sum(dim=-1))
            d_mesh = torch.sqrt(diff[..., world_dim:].square().sum(dim=-1))
            member, valid = static.member_idx, static.member_valid

            def spread(d):
                g = d.index_select(d.dim() - 1, member.reshape(-1).long())
                g = g.reshape(d.shape[:-1] + tuple(member.shape))
                g = torch.where(valid > 0, g, -torch.inf)
                s = g.amax(dim=-1)
                return torch.where(torch.isfinite(s), s, torch.zeros_like(s))

            sizes = static.sizes.expand(d_world.shape[:-1] + (K,))
            aug_raw = torch.stack([sizes, spread(d_mesh), spread(d_world)], dim=-1)
            # padded clusters stay out of the hyper normalizer's statistics
            cluster_valid = (sizes > 0).to(torch.float32)
            aug, state = model._normalize(
                state, "hyper_node", aug_raw, accumulate=is_training, mask=cluster_valid
            )
            hyper_features = torch.cat([node_feature_means, aug], dim=-1)
        else:
            hyper_features = node_feature_means

        up_raw = _rows(_edge_feats(diff, world_dim), static.up_perm)
        down_raw = _rows(_edge_feats(-diff, world_dim), static.down_perm)
        bmask = lambda m, like: m.expand(like.shape[:-1])
        # the intra normalizer accumulates once per edge set, as the JAX package's
        up_feats, state = model._normalize(
            state, "intra_edge", up_raw, accumulate=is_training, mask=bmask(static.up_mask, up_raw)
        )
        down_feats, state = model._normalize(
            state, "intra_edge", down_raw, accumulate=is_training,
            mask=bmask(static.down_mask, down_raw),
        )
        # hyper j sits at row N + j of the concatenated node array
        means_pad = torch.cat([torch.zeros_like(coords), means], dim=-2)
        rel_inter = _rows(means_pad, static.inter_senders) - _rows(means_pad, static.inter_receivers)
        inter_raw = _edge_feats(rel_inter, world_dim)
        inter_feats, state = model._normalize(
            state, "inter_edge", inter_raw, accumulate=is_training,
            mask=bmask(static.inter_mask, inter_raw),
        )

        rows = graph.num_nodes + K
        edge_sets = {}
        # the existing sets aggregate into N + K rows now
        for name, es in graph.edge_sets.items():
            es = es.replace(
                gather_idx=_pad_rows(es.gather_idx, K),
                gather_valid=_pad_rows(es.gather_valid, K),
                snd_gather_idx=_pad_rows(es.snd_gather_idx, K),
                snd_gather_valid=_pad_rows(es.snd_gather_valid, K),
                sums=None if es.sums is None else es.sums.with_rows(rows),
            )
            if name == "mesh_edges" and static.mesh_plan is not None:
                es = es.replace(plan=static.mesh_plan)
            edge_sets[name] = es

        def mk(name, feats, snd, rcv, mask, gather, sums, plan):
            edge_sets[name] = EdgeSet(
                features=feats * mask[:, None],
                senders=snd,
                receivers=rcv,
                mask=mask,
                plan=plan,
                gather_idx=gather[0],
                gather_valid=gather[1],
                sums=sums,
            )

        mk("intra_cluster_to_cluster", up_feats, static.up_senders, static.up_receivers,
           static.up_mask, static.up_gather, static.up_sums, static.up_plan)
        mk("intra_cluster_to_mesh", down_feats, static.down_senders, static.down_receivers,
           static.down_mask, static.down_gather, static.down_sums, static.down_plan)
        mk("inter_cluster", inter_feats, static.inter_senders, static.inter_receivers,
           static.inter_mask, static.inter_gather, static.inter_sums, static.inter_plan)

        if self.inter_world and static.inter_world_senders is not None:
            # features through the inter normalizer, cut to width 4 as the
            # reference does
            iw_s, iw_r, iw_m = (
                static.inter_world_senders, static.inter_world_receivers, static.inter_world_mask,
            )
            iw_raw = _edge_feats(_rows(means_pad, iw_s) - _rows(means_pad, iw_r), world_dim)
            iw_feats, state = model._normalize(
                state, "inter_edge", iw_raw, accumulate=is_training, mask=bmask(iw_m, iw_raw)
            )
            edge_sets["inter_cluster_world"] = EdgeSet(
                features=iw_feats[..., :4] * iw_m[:, None], senders=iw_s, receivers=iw_r,
                mask=iw_m, plan=static.inter_world_plan, sums=static.inter_world_sums,
            )

        return graph.replace(edge_sets=edge_sets, hyper_features=hyper_features), state


class MultigraphConnector(HierarchicalConnector):
    """The hierarchical connector's sets folded back into ``mesh_edges``
    with one-hot edge-type tags ``[mesh, inter, up, down]``, and a one-hot
    tier tag on every node."""

    name = "multi"
    edge_set_names = ()

    def initialize(self) -> list:
        return []

    def expand(self, state, graph, static, target_feature, mesh_features, model,
               is_training, normal=None, generator=None):
        graph, state = super().expand(
            state, graph, static, target_feature, mesh_features, model, is_training,
            normal=normal, generator=generator,
        )
        sets = graph.edge_sets
        parts = [sets[n] for n in ("mesh_edges", "inter_cluster",
                                   "intra_cluster_to_cluster", "intra_cluster_to_mesh")]

        def tag(x, i, width):
            onehot = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype, device=x.device)
            onehot[..., i] = 1.0
            return torch.cat([x, onehot], dim=-1)

        def mask(es):
            if es.mask is not None:
                return es.mask
            return torch.ones(es.num_edges, dtype=torch.float32, device=es.senders.device)

        feats = [tag(es.features, i, 4) for i, es in enumerate(parts)]
        batch = torch.broadcast_shapes(*(f.shape[:-2] for f in feats))
        merged = EdgeSet(
            features=torch.cat([f.expand(batch + f.shape[-2:]) for f in feats], dim=-2),
            senders=torch.cat([es.senders for es in parts]),
            receivers=torch.cat([es.receivers for es in parts]),
            mask=torch.cat([mask(es) for es in parts]),
            sums=static.merged_sums,
        )
        new_sets = {"mesh_edges": merged}
        for name in ("world_edges", "balance"):
            if name in sets:
                new_sets[name] = sets[name]
        return graph.replace(
            edge_sets=new_sets,
            node_features=tag(graph.node_features, 0, 2),
            hyper_features=tag(graph.hyper_features, 1, 2),
        ), state


def get_connector(name: str, rmp_config: dict):
    """The configured connector, or None for ``none`` and ``repeated``."""
    name = name.lower()
    fully_connect = rmp_config.get("fully_connect", False)
    noise = rmp_config.get("hyper_noise")
    hnf = rmp_config.get("hyper_node_features", True)
    inter_mode = rmp_config.get("inter_mode", "neighbors")
    inter_world = rmp_config.get("inter_cluster_world", False)
    if name in ("hyper", "hetero", "multiscale"):
        return HierarchicalConnector(fully_connect, noise, hnf, inter_mode, inter_world)
    if name == "multi":
        return MultigraphConnector(fully_connect, noise, hnf, inter_mode)
    if name in ("none", "repeated"):
        return None
    raise NotImplementedError(f"unknown connector {name!r}")
