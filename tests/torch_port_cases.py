"""Shared inputs for the port's parity tests (tests/test_torch_port_*.py).

Every input is drawn with numpy from a seed and handed to both the JAX
package and the port, so neither framework's RNG matters.
"""
import numpy as np

from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation

# bf16 keeps 8 significant bits: one unit in the last place is 2**-7 of the
# value's leading power of two.
BF16_ULP = 2.0**-7


def grid_edges(nx: int, ny: int):
    """Receiver-sorted (senders, receivers, num_nodes) of an nx x ny grid."""
    edges = cells_to_edges(_grid_triangulation(nx, ny))
    return edges.senders, edges.receivers, nx * ny


def masked_edge_case(seed: int = 0, B: int = 2, L: int = 32):
    """K1 inputs on an 8x8 grid with an isolated receiver and a masked tail.

    Receiver 10 loses all its incoming edges (its aggregate must be 0), and
    7 masked edges are appended with receiver N-1, so receivers stay sorted
    and the masked edges add nothing to any aggregate.
    """
    rng = np.random.default_rng(seed)
    snd, rcv, N = grid_edges(8, 8)
    keep = rcv != 10
    snd, rcv = snd[keep], rcv[keep]
    num_valid, pad = len(snd), 7
    snd = np.concatenate([snd, np.zeros(pad, np.int32)])
    rcv = np.concatenate([rcv, np.full(pad, N - 1, np.int32)])
    mask = np.r_[np.ones(num_valid), np.zeros(pad)].astype(np.float32)
    arrays, weights = _k1_arrays(rng, B, len(snd), N, L)
    return arrays, weights, snd, rcv, mask, N, num_valid


def interior_mask_case(seed: int = 0, B: int = 2, L: int = 32):
    """K1 inputs on an 8x8 grid with masked edges inside receivers'
    segments, spread through the mesh as the graph balancer's removals are
    (every seventh edge from the fourth), and receiver 10 with all its edges
    masked (its aggregate must be 0).  Receivers stay sorted; no tail."""
    rng = np.random.default_rng(seed)
    snd, rcv, N = grid_edges(8, 8)
    mask = np.ones(len(rcv), np.float32)
    mask[3::7] = 0.0
    mask[rcv == 10] = 0.0
    arrays, weights = _k1_arrays(rng, B, len(snd), N, L)
    return arrays, weights, snd, rcv, mask, N


def long_segment_case(seed: int = 0, B: int = 2, L: int = 32):
    """K1 inputs whose receivers own more edges than one kernel tile.

    Receiver 3 has 150 edges and receiver 7 exactly 64, so their aggregates
    are carried across tiles; receiver 9 has none; about a tenth of the
    edges, some inside the long segments, are masked.
    """
    rng = np.random.default_rng(seed)
    N = 40
    counts = np.full(N, 2)
    counts[3], counts[7], counts[9] = 150, 64, 0
    rcv = np.repeat(np.arange(N), counts).astype(np.int32)
    snd = rng.integers(0, N, size=len(rcv)).astype(np.int32)
    mask = (rng.random(len(rcv)) > 0.1).astype(np.float32)
    arrays, weights = _k1_arrays(rng, B, len(rcv), N, L)
    return arrays, weights, snd, rcv, mask, N


def tie_edge_case(seed: int = 0, B: int = 2, L: int = 32):
    """K1 inputs on a 6x6 grid in which every third receiver gets its first
    edge twice: the same sender, receiver and features, so the two copies'
    e2 tie exactly in every column.  Returns the usual tuple plus the edge
    positions of the second copies."""
    rng = np.random.default_rng(seed)
    snd, rcv, N = grid_edges(6, 6)
    arrays, weights = _k1_arrays(rng, B, len(snd), N, L)
    dup = np.asarray(
        [np.flatnonzero(rcv == n)[0] for n in range(0, N, 3) if np.any(rcv == n)]
    )
    order = np.sort(np.concatenate([np.arange(len(snd)), dup]))  # copies adjacent
    copies = np.flatnonzero(np.diff(order) == 0) + 1
    arrays["e"] = np.ascontiguousarray(arrays["e"][:, order])
    mask = np.ones(len(order), np.float32)
    return arrays, weights, snd[order], rcv[order], mask, N, copies


def tier_set_case(name, members=(150, 81, 60, 0), tail=12, seed=5, B=2, L=32):
    """A cluster-tier set (``up``, ``down`` or ``inter``) of ``build_static``
    on a clustering of ``sum(members) + tail`` mesh nodes into 4 clusters
    (one of them empty; each cluster's nodes spread over the mesh) and
    ``tail`` non-members (obstacle nodes, label -1), padded as
    ``_pad_static`` pads it, so its valid edges form a receiver-sorted
    prefix and its masked tail names receivers out of order.  Returns
    ``(arrays, weights, senders, receivers, mask, rows)`` (K1 inputs over
    the ``N + K`` rows, weights in the JAX layout)."""
    from hyper_graph_nets_tpu_torch.rmp.clustering import Clustering
    from hyper_graph_nets_tpu_torch.rmp.connector import build_static
    from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import RemoteMessagePassing

    rng = np.random.default_rng(seed)
    n_mem = sum(members)
    labels = np.concatenate([rng.permutation(np.repeat(np.arange(len(members)), members)), -np.ones(tail, int)])
    clusters = [np.flatnonzero(labels == k) for k in range(len(members))]
    neighbors = [(a, b) for a in range(3) for b in range(3) if a != b]
    clustering = Clustering(labels, clusters, neighbors, len(members))
    static = RemoteMessagePassing._pad_static(build_static(clustering, n_mem + tail))
    snd, rcv, mask = (np.asarray(getattr(static, f"{name}_{f}")) for f in ("senders", "receivers", "mask"))
    rows = n_mem + tail + static.num_clusters
    arrays, weights = _k1_arrays(rng, B, len(snd), rows, L)
    return arrays, weights, snd.astype(np.int32), rcv.astype(np.int32), mask.astype(np.float32), rows


def _k1_arrays(rng, B, E, N, L):
    arrays = {
        "e": rng.normal(size=(B, E, L)).astype(np.float32),
        "sp": rng.normal(size=(B, N, L)).astype(np.float32),
        "rp": rng.normal(size=(B, N, L)).astype(np.float32),
    }
    # JAX layout [in, out]
    weights = {k: (0.3 * rng.normal(size=(L, L))).astype(np.float32) for k in ("we", "w2", "w3")}
    weights.update({k: (0.1 * rng.normal(size=L)).astype(np.float32) for k in ("b1", "b2", "b3")})
    weights["lns"] = (1.0 + 0.1 * rng.normal(size=L)).astype(np.float32)
    weights["lnb"] = (0.1 * rng.normal(size=L)).astype(np.float32)
    return arrays, weights


def flag_config(compute_dtype, agg_vjp="fused", mp_steps=2, latent=32):
    """Flag MeshGraphNets config dict shared by the JAX and port predictors."""
    return {
        "params": {
            "task": {"dataset": "flag_simple"},
            "model": {
                "field": "world_pos",
                "history": True,
                "size": 3,
                "aggregation": "pna",
                "agg_vjp": agg_vjp,
                "message_passing_steps": mp_steps,
                "latent_size": latent,
                "compute_dtype": compute_dtype,
                "rmp": {"clustering": "none", "connector": "none"},
                "graph_balancer": {"algorithm": "none"},
            },
        }
    }
