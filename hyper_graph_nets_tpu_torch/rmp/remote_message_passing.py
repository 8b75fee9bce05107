"""Remote message passing: the cluster cache and the graph expansion.

Counterpart of ``hyper_graph_nets_tpu/rmp/remote_message_passing.py``.
:meth:`RemoteMessagePassing.prepare` clusters one frame on the host (when
the cache is empty), builds the static incidence (``rmp.connector.
build_static``), pads the cluster count K and the per-cluster degree dims
to powers of two, attaches the port's fixed-order sums and the mesh set's
fused plan over ``N + K`` rows, and moves it to the topology's device;
:meth:`RemoteMessagePassing.expand` adds the hyper tier and the remote edge
sets to a graph of the current frames.

Obstacle nodes (plate) are left out of the clustering (label -1,
membership 0).  The cluster-tier sets run unfused, as in the JAX package
without ``rmp.fused_tiers``; with ``fused_tiers: true`` and ``agg_vjp:
fused`` the up, down, inter and inter-world sets that the JAX package's
``_attach_band_plans`` fuses get a K1/K2 plan over their valid prefix
(``ops.fused_block.plan_segments(num_valid=)``).  The JAX package forces
those plans' dims so that a recluster does not recompile; nothing
recompiles here, so the port's plans are the sets' own.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums
from hyper_graph_nets_tpu_torch.rmp.clustering import Clustering, HostGraph, get_clustering_algorithm
from hyper_graph_nets_tpu_torch.rmp.connector import (
    MultigraphConnector,
    RMPStatic,
    build_static,
    get_connector,
)


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_gather_cols(gather, target: int):
    gidx, gval = np.asarray(gather[0]), np.asarray(gather[1])
    pad = target - gidx.shape[1]
    if pad <= 0:
        return gidx, gval
    return np.pad(gidx, ((0, 0), (0, pad))), np.pad(gval, ((0, 0), (0, pad)))


class RemoteMessagePassing:
    """Clusters once per reset; expands every graph with the cached static."""

    def __init__(self, clustering_algorithm, connector):
        self._clustering = clustering_algorithm
        self._connector = connector
        self._static: Optional[RMPStatic] = None
        self._last_clustering: Optional[Clustering] = None
        self.last_coordinates: Optional[np.ndarray] = None

    @property
    def connector(self):
        return self._connector

    @property
    def static(self) -> Optional[RMPStatic]:
        """The cached static (None before :meth:`prepare`)."""
        return self._static

    def initialize(self) -> list:
        return self._connector.initialize()

    def reset_clusters(self) -> None:
        """Recluster at the next :meth:`prepare`."""
        self._static = None

    # ------------------------------------------------------------------
    def prepare(self, model, frame: Dict[str, np.ndarray], topo) -> RMPStatic:
        """Host: cluster ``frame`` unless cached; returns the static on the
        topology's device."""
        if self._static is not None:
            return self._static
        host = model.host_graph(frame, topo)
        if host.obstacle_mask is not None and host.obstacle_mask.any():
            clustering = self._cluster_without_obstacles(host)
        else:
            clustering = self._clustering.run(host)
        self._last_clustering = clustering
        self.last_coordinates = np.asarray(host.target_feature)
        inter_mode = getattr(self._connector, "inter_mode", "neighbors")
        centers = None
        if inter_mode == "delaunay":
            centers = np.stack(
                [
                    host.mesh_features[c].mean(axis=0) if len(c) else np.zeros(host.mesh_features.shape[1])
                    for c in clustering.clusters
                ]
            )
        inter_world = getattr(self._connector, "inter_world", False)
        world_labels = None
        if inter_world:
            receivers = model.world_edge_receiver_nodes(frame, topo)
            if receivers is not None and len(receivers):
                world_labels = np.asarray(clustering.labels)[np.asarray(receivers, np.int64)]
        static = build_static(
            clustering,
            topo.num_nodes,
            fully_connect=self._connector.fully_connect,
            inter_mode=inter_mode,
            cluster_centers=centers,
            inter_world=inter_world,
            world_collide_labels=world_labels,
        )
        static = self._pad_static(static)
        static = self._attach_plans(static, model, topo)
        self._static = static.to(topo.senders.device)
        return self._static

    def _cluster_without_obstacles(self, host: HostGraph) -> Clustering:
        keep = ~np.asarray(host.obstacle_mask)
        idx = np.nonzero(keep)[0]
        remap = -np.ones(len(keep), np.int64)
        remap[idx] = np.arange(len(idx))
        emask = keep[host.senders] & keep[host.receivers]
        sub = HostGraph(
            target_feature=host.target_feature[idx],
            mesh_features=host.mesh_features[idx],
            senders=remap[host.senders[emask]].astype(np.int32),
            receivers=remap[host.receivers[emask]].astype(np.int32),
            edge_features=host.edge_features[emask],
            node_dynamic=None if host.node_dynamic is None else host.node_dynamic[idx],
            obstacle_mask=None,
            world_dim=host.world_dim,
        )
        clustering = self._clustering.run(sub)
        labels = -np.ones(len(keep), int)
        labels[idx] = clustering.labels
        return Clustering(
            labels=labels,
            clusters=[idx[c] for c in clustering.clusters],
            neighbors=clustering.neighbors,
            num_clusters=clustering.num_clusters,
        )

    @staticmethod
    def _pad_static(static: RMPStatic) -> RMPStatic:
        """Pad K and the per-cluster degree dims to powers of two.  Padded
        clusters have zero assignment rows, mask-0 incidence and no down
        edges, so they are inert in the network."""
        K = static.assign_mean.shape[0]
        pad_k = _round_pow2(K) - K

        def pad_rows(x):
            return np.pad(np.asarray(x), ((0, pad_k),) + ((0, 0),) * (np.ndim(x) - 1))

        if pad_k:
            static = static._replace(
                assign_mean=pad_rows(static.assign_mean),
                sizes=pad_rows(static.sizes),
                member_idx=pad_rows(static.member_idx),
                member_valid=pad_rows(static.member_valid),
                # up/down receivers address rows N + label: the row space
                # grows to N + Kp
                up_gather=tuple(pad_rows(g) for g in static.up_gather),
                down_gather=tuple(pad_rows(g) for g in static.down_gather),
                inter_gather=tuple(pad_rows(g) for g in static.inter_gather),
            )
            Kp = K + pad_k
            p = static.inter_senders.shape[0]
            if p < Kp * (Kp - 1):
                pad_p = Kp * (Kp - 1) - p
                pad = lambda x: np.pad(x, (0, pad_p))
                static = static._replace(
                    inter_senders=pad(static.inter_senders),
                    inter_receivers=pad(static.inter_receivers),
                    inter_mask=pad(static.inter_mask),
                )
                if static.inter_world_senders is not None:
                    static = static._replace(
                        inter_world_senders=pad(static.inter_world_senders),
                        inter_world_receivers=pad(static.inter_world_receivers),
                        inter_world_mask=pad(static.inter_world_mask),
                    )
        m_max = _round_pow2(static.member_idx.shape[1])
        cols = lambda x: np.pad(x, ((0, 0), (0, m_max - x.shape[1])))
        return static._replace(
            up_gather=_pad_gather_cols(static.up_gather, _round_pow2(static.up_gather[0].shape[1])),
            down_gather=_pad_gather_cols(static.down_gather, _round_pow2(static.down_gather[0].shape[1])),
            inter_gather=_pad_gather_cols(static.inter_gather, _round_pow2(static.inter_gather[0].shape[1])),
            member_idx=cols(static.member_idx),
            member_valid=cols(static.member_valid),
        )

    def _attach_plans(self, static: RMPStatic, model, topo) -> RMPStatic:
        """The fixed-order sums of the cluster-tier sets and, when the mesh
        set runs the fused kernels, its plan over ``N + Kp`` rows, whose
        hyper rows receive nothing.  The cluster-tier sets run unfused
        unless ``rmp.fused_tiers`` (:func:`_tier_plans`)."""
        from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan, plan_segments

        rows = topo.num_nodes + static.num_clusters
        sums = lambda s, r: EdgeSums.build(s, r, rows)
        extra = {}
        if static.inter_world_senders is not None:
            extra["inter_world_sums"] = sums(static.inter_world_senders, static.inter_world_receivers)
        if isinstance(self._connector, MultigraphConnector):
            cat = lambda *xs: np.concatenate([np.asarray(x, np.int64) for x in xs])
            snd, rcv = topo.senders.cpu().numpy(), topo.receivers.cpu().numpy()
            extra["merged_sums"] = sums(
                cat(snd, static.inter_senders, static.up_senders, static.down_senders),
                cat(rcv, static.inter_receivers, static.up_receivers, static.down_receivers),
            )
        if isinstance(topo.plan, SegmentPlan):
            extra["mesh_plan"] = plan_segments(topo.receivers, rows, senders=topo.senders)
        if model.params["model"].get("agg_vjp") == "fused" and model.rmp_config.get("fused_tiers", False):
            extra.update(_tier_plans(static, topo.num_nodes, model.params["model"].get("fused_chunk")))
        return static._replace(
            up_sums=sums(static.up_senders, static.up_receivers),
            down_sums=sums(static.down_senders, static.down_receivers),
            inter_sums=sums(static.inter_senders, static.inter_receivers),
            **extra,
        )

    # ------------------------------------------------------------------
    def expand(
        self,
        state,
        graph,
        frames,
        model,
        is_training: bool,
        static: Optional[RMPStatic] = None,
        normal: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Add the hyper tier and the remote edge sets (one frame or a
        batch); ``normal`` and ``generator`` as in the connector's
        ``expand``."""
        static = static if static is not None else self._static
        if static is None:
            raise RuntimeError("RemoteMessagePassing.prepare() must run first")
        static = static.to(graph.node_features.device)
        target, mesh = model.geometry(frames)
        return self._connector.expand(
            state, graph, static, target, mesh, model, is_training,
            normal=normal, generator=generator,
        )

    def visualize_cluster(self, coordinates: np.ndarray, out_path: Optional[str] = None):
        """The last clustering's labels drawn over ``coordinates`` as a 3-D
        scatter PNG at ``out_path`` (returns the path), or the labels when
        no path is given or matplotlib does not import."""
        if self._last_clustering is None:
            return None
        labels = np.asarray(self._last_clustering.labels)
        if out_path is None:
            return labels
        try:
            import matplotlib
        except ImportError:
            return labels
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(111, projection="3d")
        pts = np.asarray(coordinates)
        if pts.shape[1] == 2:
            pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=labels, cmap="tab20", s=4)
        fig.savefig(out_path, dpi=80)
        plt.close(fig)
        return out_path


def _tier_plans(static: RMPStatic, num_nodes: int, chunk: Optional[int]) -> dict:
    """K1/K2 plans over ``N + Kp`` rows for the cluster-tier sets that the
    JAX package fuses under ``rmp.fused_tiers`` (``_attach_band_plans``,
    ``rmp/remote_message_passing.py:238-335``), by its rule: the valid edges
    form a receiver-sorted prefix, and every window of its band plan (the
    plan dims' bounds and each chunk's sender and receiver spans, one
    sender subwindow a chunk) fits 2,048 rows.  Any other set stays
    unfused (its plan None), as there."""
    from hyper_graph_nets_tpu_torch.ops.fused_block import plan_segments
    from hyper_graph_nets_tpu_torch.ops.reorder import default_chunk, window_dims

    chunk = chunk or default_chunk()
    N, Kp = int(num_nodes), static.num_clusters
    rows = N + Kp
    ru = lambda x: (x + 127) // 128 * 128
    max_window = 2048

    def plan(snd, rcv, mask, bound):
        snd, rcv, m = np.asarray(snd), np.asarray(rcv), np.asarray(mask)
        ev = int(m.sum())
        if ev and (m[:ev].min() <= 0 or np.any(np.diff(rcv[:ev]) < 0)):
            return None
        if max(bound, 128) > max_window:
            return None
        dims = window_dims(snd, rcv, num_valid=ev, chunk=chunk, sb=1)
        if dims is None or max(dims) > max_window:
            return None
        return plan_segments(rcv, rows, senders=snd, num_valid=ev)

    kb = ru(Kp + 16)
    out = dict(
        # up: senders any mesh node, receivers the hyper rows
        up_plan=plan(static.up_senders, static.up_receivers, static.up_mask, max(ru(N + 16), ru(Kp + 8))),
        down_plan=plan(static.down_senders, static.down_receivers, static.down_mask, kb),
        inter_plan=plan(static.inter_senders, static.inter_receivers, static.inter_mask, kb),
    )
    if static.inter_world_senders is not None:
        out["inter_world_plan"] = plan(
            static.inter_world_senders, static.inter_world_receivers, static.inter_world_mask, kb
        )
    return out


def get_rmp(config: dict) -> Optional[RemoteMessagePassing]:
    """The configured remote message passing, or None."""
    params = config.get("params", config)
    rmp_cfg = params["model"].get("rmp", {})
    clustering = get_clustering_algorithm(rmp_cfg.get("clustering", "none"), rmp_cfg)
    connector = get_connector(rmp_cfg.get("connector", "none"), rmp_cfg)
    if clustering is None or connector is None:
        return None
    return RemoteMessagePassing(clustering, connector)
