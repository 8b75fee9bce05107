"""Clustering for remote message passing (host numpy and scipy).

Counterpart of ``hyper_graph_nets_tpu/rmp/clustering.py``:

- :class:`HostGraph` and :class:`Clustering`, empty-cluster repair,
  cross-cluster neighbours and the intra-cluster sampling pipeline
  (spotter, exemplars, highest dynamics, alpha-subsampling);
- :class:`RandomClustering` with the JAX package's two streams:
  ``np.random.RandomState(seed)`` for the labels and the sampling, Python's
  ``random.Random(seed)`` for empty-cluster repair and the shuffles;
- :class:`SpectralClustering` on the mesh-edge affinity, written with scipy
  alone.  The JAX package calls ``sklearn.cluster.SpectralClustering(
  affinity="precomputed", assign_labels="cluster_qr", random_state=0)``;
  :func:`spectral_labels` takes the same steps as scikit-learn 1.9's
  ``_spectral_embedding`` and ``cluster_qr`` (normalized Laplacian with a
  unit diagonal, ARPACK in shift-invert mode at sigma = -1e-5 from a
  ``RandomState(0)`` start vector, division by the degree roots, the sign
  flip, then a pivoted QR and an SVD), in float64, so it gives the same
  labels node for node without scikit-learn installed;
- :class:`KMeansClustering` on the standardized mesh coordinates and
  :class:`GaussianMixtureClustering` on the standardized world stream,
  through ``rmp.sk_numpy``'s copies of scikit-learn 1.9's
  ``StandardScaler``, ``KMeans(random_state=0, n_init=10)`` and
  ``GaussianMixture(random_state=0, init_params="k-means++")``;
- :class:`HDBSCANClustering` through ``rmp.hdbscan_tree``, with a cluster
  count that follows the data (one cluster of every node when all are
  noise) and, with sampling, spotters chosen by the gap between a node's
  two largest soft memberships.

Clustering runs on the host at each reset of the expansion; its result
becomes the static incidence of ``rmp.connector``.
"""
from __future__ import annotations

import random as pyrandom
from typing import List, NamedTuple, Optional

import numpy as np

from hyper_graph_nets_tpu_torch.rmp import hdbscan_tree, sk_numpy


class HostGraph(NamedTuple):
    """Numpy snapshot of one frame's graph for clustering."""

    target_feature: np.ndarray  # [N, Dw] world stream
    mesh_features: np.ndarray  # [N, Dm]
    senders: np.ndarray  # [E] mesh edges
    receivers: np.ndarray  # [E]
    edge_features: np.ndarray  # [E, F] unnormalized mesh edge features
    node_dynamic: Optional[np.ndarray] = None  # [N]
    obstacle_mask: Optional[np.ndarray] = None  # [N] bool
    world_dim: int = 3


class Clustering(NamedTuple):
    """Labels per node (-1: unclustered) and the (sampled) member lists."""

    labels: np.ndarray  # [N] int
    clusters: List[np.ndarray]  # per-cluster member indices
    neighbors: List[tuple]  # cross-cluster adjacency pairs (a, b), a < b
    num_clusters: int


def _labels_to_indices(labels: List[int]) -> List[np.ndarray]:
    """Members of each label, skipping negative labels."""
    k = max(labels) + 1 if len(labels) else 0
    out = [[] for _ in range(k)]
    for i, l in enumerate(labels):
        if l >= 0:
            out[l].append(i)
    return [np.asarray(x, np.int64) for x in out]


def _empty_cluster_handling(labels: List[int], num_clusters: int, rng) -> List[int]:
    """Move a random member of a random non-empty cluster into each empty one."""
    result = [[] for _ in range(num_clusters)]
    for i, l in enumerate(labels):
        result[l].append(i)
    for c in range(num_clusters):
        if not result[c]:
            donor = rng.choice([x for x in range(num_clusters) if result[x]])
            labels[rng.choice(result[donor])] = c
    return labels


def get_neighbors(graph: HostGraph, labels: np.ndarray) -> List[tuple]:
    """Sorted cluster pairs joined by a mesh edge."""
    snd_l = labels[graph.senders]
    rcv_l = labels[graph.receivers]
    cross = snd_l != rcv_l
    pairs = set()
    for a, b in zip(snd_l[cross], rcv_l[cross]):
        if a >= 0 and b >= 0:
            pairs.add(tuple(sorted((int(a), int(b)))))
    return sorted(pairs)


class ClusteringAlgorithm:
    """The ``run`` pipeline: labels, empty-cluster repair, neighbours and
    (with ``sampling``) the sampled member lists."""

    def __init__(
        self,
        num_clusters: int = 10,
        sampling: bool = False,
        alpha: float = 0.5,
        threshold: int = 0,
        seed: int = 0,
    ):
        self.num_clusters = num_clusters
        self.sampling = sampling
        self.alpha = alpha
        self.threshold = threshold
        self._rng = pyrandom.Random(seed)

    def _cluster(self, graph: HostGraph) -> np.ndarray:
        raise NotImplementedError

    def run(self, graph: HostGraph) -> Clustering:
        labels = list(int(x) for x in self._cluster(graph))
        labels = _empty_cluster_handling(labels, self.num_clusters, self._rng)
        labels = np.asarray(labels)
        neighbors = get_neighbors(graph, labels)
        if not self.sampling:
            clusters = _labels_to_indices(list(labels))
        else:
            spotter = self.spotter(graph, labels)
            exemplars = self.exemplars(labels, spotter)
            top_k = self.highest_dynamics(graph, labels)
            clusters = [
                np.asarray(sorted(set(s) | set(e) | set(t)), np.int64)
                for s, e, t in zip(spotter, exemplars, top_k)
            ]
        return Clustering(labels=labels, clusters=clusters, neighbors=neighbors,
                          num_clusters=self.num_clusters)

    # -- intra-cluster sampling ------------------------------------------
    def spotter(self, graph: HostGraph, labels: np.ndarray) -> List[List[int]]:
        """Boundary nodes of cross-cluster edges seen at least ``threshold``
        times, in each endpoint's cluster."""
        snd_l = labels[graph.senders]
        rcv_l = labels[graph.receivers]
        cross = np.nonzero(snd_l != rcv_l)[0]
        buckets: List[List[int]] = [[] for _ in range(self.num_clusters)]
        for e in cross:
            buckets[snd_l[e]].append(int(graph.senders[e]))
            buckets[rcv_l[e]].append(int(graph.receivers[e]))
        out = [[x for x in set(b) if b.count(x) >= self.threshold] for b in buckets]
        return self._reduce_samples(out, shuffle=True)

    def exemplars(self, labels: np.ndarray, spotter: List[List[int]]) -> List[List[int]]:
        """Random members of each cluster that are not its spotters."""
        out: List[List[int]] = [[] for _ in range(self.num_clusters)]
        spotset = [set(s) for s in spotter]
        for i, l in enumerate(labels):
            if l >= 0 and i not in spotset[l]:
                out[l].append(i)
        return self._reduce_samples(out, shuffle=True)

    def highest_dynamics(self, graph: HostGraph, labels: np.ndarray) -> List[List[int]]:
        """The members of each cluster with the largest ``node_dynamic``."""
        out: List[List[int]] = [[] for _ in range(self.num_clusters)]
        for i, l in enumerate(labels):
            if l >= 0:
                out[l].append(i)
        if graph.node_dynamic is None:
            return self._reduce_samples(out, shuffle=False)
        dyn = np.asarray(graph.node_dynamic).reshape(-1)
        out = [sorted(b, key=lambda x: -dyn[x]) for b in out]
        return self._reduce_samples(out, shuffle=False)

    def _reduce_samples(self, result: List[List[int]], shuffle: bool) -> List[List[int]]:
        """Keep ``max(alpha * 100, alpha * len)`` of each bucket (at most all)."""
        for i in range(len(result)):
            if shuffle:
                self._rng.shuffle(result[i])
            threshold = max(int(self.alpha * 100), int(len(result[i]) * self.alpha))
            threshold = min(len(result[i]), threshold)
            result[i] = result[i][:threshold]
        return result


class RandomClustering(ClusteringAlgorithm):
    """Uniform random labels; sampling keeps a random ``alpha`` share."""

    def __init__(self, num_clusters, sampling, alpha, threshold, seed: int = 0):
        super().__init__(num_clusters, sampling, alpha, threshold, seed)
        self._np_rng = np.random.RandomState(seed)

    def _cluster(self, graph: HostGraph) -> np.ndarray:
        n = graph.target_feature.shape[0]
        return (self._np_rng.rand(n) * self.num_clusters).astype(int)

    def run(self, graph: HostGraph) -> Clustering:
        labels = list(int(x) for x in self._cluster(graph))
        labels = _empty_cluster_handling(labels, self.num_clusters, self._rng)
        labels = np.asarray(labels)
        clusters = _labels_to_indices(list(labels))
        if self.sampling:
            sampled = []
            for c in clusters:
                perm = self._np_rng.permutation(len(c))
                sampled.append(c[perm[: int(len(c) * self.alpha) + 1]])
            clusters = sampled
        return Clustering(labels=labels, clusters=clusters,
                          neighbors=get_neighbors(graph, labels), num_clusters=self.num_clusters)


def _sign_flip(u: np.ndarray) -> np.ndarray:
    """Flip each row of ``u`` so that its largest-magnitude entry is positive."""
    max_abs = np.argmax(np.abs(u), axis=1)
    signs = np.sign(u[range(u.shape[0]), max_abs])
    return u * signs[:, None]


def _cluster_qr(vectors: np.ndarray) -> np.ndarray:
    """Labels nearest to the embedding: pivoted QR, then an SVD of the pivot
    rows (Damle, Minden and Ying, 2019)."""
    from scipy.linalg import qr, svd

    k = vectors.shape[1]
    _, _, piv = qr(vectors.T, pivoting=True)
    ut, _, v = svd(vectors[piv[:k], :].T)
    return np.abs(vectors @ (ut @ v.conj())).argmax(axis=1)


def spectral_labels(affinity, num_clusters: int, seed: int = 0) -> np.ndarray:
    """Spectral clustering of a sparse precomputed affinity with
    ``cluster_qr`` label assignment: scikit-learn 1.9's steps, in float64."""
    from scipy import sparse
    from scipy.sparse.csgraph import laplacian
    from scipy.sparse.linalg import eigsh

    adjacency = sparse.csr_matrix(affinity, dtype=np.float64)
    diff = adjacency - adjacency.T
    if not np.all(np.abs(diff.data) < 1e-10):
        adjacency = (0.5 * (adjacency + adjacency.T)).tocsr()
    lap, dd = laplacian(adjacency, normed=True, return_diag=True)
    # unit diagonal, then the format scikit-learn hands ARPACK
    lap = lap.tocoo()
    lap.data[lap.row == lap.col] = 1
    if np.unique(lap.row - lap.col).size <= 7:
        lap = lap.todia()
    else:
        lap = lap.tocsr()
    lap = sparse.csr_matrix(lap)
    v0 = np.random.RandomState(seed).uniform(-1, 1, lap.shape[0])
    _, vectors = eigsh(lap, k=num_clusters, sigma=-1e-5, which="LM", tol=0, v0=v0)
    embedding = _sign_flip(vectors.T[:num_clusters] / dd)
    return _cluster_qr(embedding.T)


class SpectralClustering(ClusteringAlgorithm):
    """Spectral clustering on the mesh-edge affinity: ``1 / sqrt(|rel_world|^2
    + |rel_mesh|^2)`` per directed mesh edge (the norm columns ``world_dim``
    and -1 of the unnormalized edge features), infinite weights replaced by
    the largest finite one plus 1."""

    def _cluster(self, graph: HostGraph) -> np.ndarray:
        return spectral_labels(self.compute_affinity_sparse(graph), self.num_clusters)

    @staticmethod
    def _affinity_weights(graph: HostGraph):
        wnorm = graph.edge_features[:, graph.world_dim]
        mnorm = graph.edge_features[:, -1]
        with np.errstate(divide="ignore"):
            w = 1.0 / np.sqrt(wnorm**2 + mnorm**2)
        finite = np.isfinite(w)
        if (~finite).any():
            w[~finite] = w[finite].max(initial=0.0) + 1
        return w, finite

    @classmethod
    def compute_affinity_sparse(cls, graph: HostGraph):
        """``[N, N]`` CSR affinity.  A repeated (sender, receiver) pair keeps
        one weight, as the dense form's writes leave it: an infinite one's
        substitute if there is one, else the last."""
        from scipy.sparse import coo_matrix

        n = graph.target_feature.shape[0]
        w, finite = cls._affinity_weights(graph)
        snd = np.asarray(graph.senders, np.int64)
        rcv = np.asarray(graph.receivers, np.int64)
        key = snd * n + rcv
        if len(np.unique(key)) != len(key):
            order = np.lexsort((np.arange(len(key)), ~finite, key))
            ks = key[order]
            keep = order[np.r_[ks[1:] != ks[:-1], True]]
            snd, rcv, w = snd[keep], rcv[keep], w[keep]
        return coo_matrix((w, (snd, rcv)), shape=(n, n)).tocsr()


class KMeansClustering(ClusteringAlgorithm):
    """k-means on the standardized mesh coordinates (``mesh_features[:, :2]``)."""

    def _cluster(self, graph: HostGraph) -> np.ndarray:
        X = sk_numpy.standard_scale(graph.mesh_features[:, :2])
        return sk_numpy.kmeans(X, self.num_clusters, random_state=0, n_init=10)


class GaussianMixtureClustering(ClusteringAlgorithm):
    """A Gaussian mixture (full covariances) on the standardized world stream."""

    def _cluster(self, graph: HostGraph) -> np.ndarray:
        X = sk_numpy.standard_scale(graph.target_feature)
        return sk_numpy.gaussian_mixture_labels(X, self.num_clusters, random_state=0)


class HDBSCANClustering(ClusteringAlgorithm):
    """HDBSCAN on the standardized world stream: the cluster count follows
    the data (``num_clusters`` is set by each :meth:`run`); noise nodes keep
    label -1.  With sampling, each cluster's members are its spotters (the
    nodes whose two largest soft memberships lie close,
    :meth:`_soft_spotter`), its exemplars (``hdbscan_tree``'s leaf points
    at the largest lambda) and its nodes of highest dynamics."""

    def __init__(
        self,
        sampling: bool,
        max_cluster_size: int,
        min_cluster_size: int,
        min_samples: int,
        spotter_threshold: float,
        alpha: float = 0.5,
        seed: int = 0,
    ):
        super().__init__(10, sampling, alpha, 0, seed)
        self.max_cluster_size = max_cluster_size
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.spotter_threshold = spotter_threshold

    def _standardize(self, graph: HostGraph) -> np.ndarray:
        return sk_numpy.standard_scale(graph.target_feature)

    def _fit(self, graph: HostGraph):
        return hdbscan_tree.hdbscan_fit(
            self._standardize(graph),
            min_cluster_size=self.min_cluster_size,
            min_samples=self.min_samples,
            max_cluster_size=self.max_cluster_size,
        )

    def run(self, graph: HostGraph) -> Clustering:
        result = self._fit(graph)
        labels = np.asarray(result.labels)
        self.num_clusters = int(labels.max()) + 1 if (labels >= 0).any() else 0
        if self.num_clusters == 0:
            # every node is noise: one cluster of all of them
            labels = np.zeros(len(labels), int)
            self.num_clusters = 1
            result = result._replace(exemplars=[list(range(len(labels)))])
        neighbors = get_neighbors(graph, labels)
        if not self.sampling:
            clusters = _labels_to_indices(list(labels))
        else:
            spotter = self._soft_spotter(graph, result)
            exemplars = [list(e) for e in result.exemplars]
            top_k = self.highest_dynamics(graph, labels)
            clusters = [
                np.asarray(sorted(set(s) | set(e) | set(t)), np.int64)
                for s, e, t in zip(spotter, exemplars, top_k)
            ]
        return Clustering(labels=labels, clusters=clusters, neighbors=neighbors,
                          num_clusters=self.num_clusters)

    def _soft_spotter(self, graph: HostGraph, result) -> List[List[int]]:
        """The nodes whose metric ``1 - (p1 - p2) / (p1 + p2)`` on their two
        largest soft memberships exceeds ``spotter_threshold``, each in the
        cluster of its largest."""
        out: List[List[int]] = [[] for _ in range(self.num_clusters)]
        if self.num_clusters < 2:
            return out
        probs = hdbscan_tree.membership_vectors(result, self._standardize(graph))
        if probs.shape[1] < 2:
            return out
        order = np.argsort(-probs, axis=1)
        rows = np.arange(len(probs))
        p1 = probs[rows, order[:, 0]]
        p2 = probs[rows, order[:, 1]]
        metric = 1.0 - (p1 - p2) / np.maximum(p1 + p2, 1e-12)
        for i in np.nonzero(metric > self.spotter_threshold)[0]:
            out[order[i, 0]].append(int(i))
        return out


def get_clustering_algorithm(name: str, rmp_config: dict) -> Optional[ClusteringAlgorithm]:
    """The configured clustering, or None for ``none``."""
    name = name.lower()
    if name == "none":
        return None
    num_clusters = rmp_config.get("num_clusters", 10)
    ics = rmp_config.get("intra_cluster_sampling", {})
    sampling = ics.get("enabled", False)
    alpha = ics.get("alpha", 0.5)
    threshold = ics.get("spotter_threshold", 0)
    if name == "random":
        return RandomClustering(num_clusters, sampling, alpha, threshold)
    if name in ("kmeans", "k-means"):
        return KMeansClustering(num_clusters, sampling, alpha, threshold)
    if name == "gmm":
        return GaussianMixtureClustering(num_clusters, sampling, alpha, threshold)
    if name == "spectral":
        return SpectralClustering(num_clusters, sampling, alpha, threshold)
    if name == "hdbscan":
        h = rmp_config.get("hdbscan", {})
        return HDBSCANClustering(
            sampling,
            h.get("max_cluster_size", 50),
            h.get("min_cluster_size", 20),
            h.get("min_samples", 1),
            h.get("spotter_threshold", 0.9),
            alpha=alpha,
        )
    raise NotImplementedError(f"unknown clustering algorithm {name!r}")
