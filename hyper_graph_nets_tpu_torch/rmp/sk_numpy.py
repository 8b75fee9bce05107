"""numpy and scipy copies of the scikit-learn 1.9 steps the clusterings use.

The JAX package clusters with ``sklearn.preprocessing.StandardScaler``,
``sklearn.cluster.KMeans`` and ``sklearn.mixture.GaussianMixture``; the
card's machine has no scikit-learn, so these functions take scikit-learn's
steps one by one, in its dtypes and its order of operations, so that a
label comes out the same node for node:

- :func:`standard_scale`: ``StandardScaler().fit_transform`` (float64
  accumulators, the population variance, a near-constant column scaled by
  1, the input's dtype kept);
- :func:`kmeans_plusplus`: ``_kmeans_plusplus`` (``2 + int(log k)`` local
  trials, the same draws from the same ``RandomState``, the distances of
  ``_euclidean_distances`` upcast to float64 in its chunks);
- :func:`kmeans`: ``KMeans(n_clusters, random_state, n_init=10)`` with
  Lloyd's iteration (``_k_means_lloyd.pyx``): X centred by its mean, the
  distances ``|c|^2 - 2 x.c`` by the same BLAS ``gemm`` call on chunks of
  256 samples, the first closest centre, the centre sums in X's dtype,
  empty clusters relocated, strict convergence or the shift tolerance, and
  the best of the inits by inertia with scikit-learn's rule for clusterings
  that are the same up to a relabelling.  scikit-learn sums the centres and
  the inertia in OpenMP threads; these are its sums on one thread;
- :func:`gaussian_mixture_labels`: ``GaussianMixture(n_components,
  random_state, init_params="k-means++").fit(X).predict(X)`` with full
  covariances (``reg_covar`` 1e-6, the precision Cholesky, ``tol`` 1e-3 on
  the lower bound, ``max_iter`` 100, one init whose responsibilities are one
  at the k-means++ indices).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

CHUNK_SIZE = 256  # samples per chunk of the Lloyd iteration


def row_norms(X: np.ndarray) -> np.ndarray:
    """Squared Euclidean norm of each row, in X's dtype."""
    return np.einsum("ij,ij->i", X, X)


def _as_float(X) -> np.ndarray:
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    return np.array(X, order="C", copy=True)


# -- StandardScaler ------------------------------------------------------------


def standard_scale(X) -> np.ndarray:
    """``StandardScaler().fit_transform(X)``."""
    X = _as_float(X)
    count = X.shape[0] - np.sum(np.isnan(X).astype(X.dtype), axis=0, dtype=np.float64)
    new_sum = np.sum(X, axis=0, dtype=np.float64)
    mean = new_sum / count
    temp = X - new_sum / count
    correction = np.sum(temp, axis=0, dtype=np.float64)
    temp **= 2
    var = np.sum(temp, axis=0, dtype=np.float64)
    var -= correction**2 / count
    var = var / count
    n = count[0]
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    X -= mean.astype(X.dtype)
    X /= scale.astype(X.dtype)
    return X


# -- k-means++ -------------------------------------------------------------------


def _batch_size(n_x: int, n_y: int, n_features: int) -> int:
    maxmem = max(((n_x + n_y) * n_features + n_x * n_y) / 10, 10 * 2**17)
    tmp = 2 * n_features
    return max(int((-tmp + math.sqrt(tmp**2 + 4 * maxmem)) / 2), 1)


def _batches(n: int, size: int):
    start = 0
    for _ in range(n // size):
        yield slice(start, start + size)
        start += size
    if start < n:
        yield slice(start, n)


def squared_distances(X: np.ndarray, Y: np.ndarray, Y_norm_squared: np.ndarray) -> np.ndarray:
    """``_euclidean_distances(X, Y, Y_norm_squared=, squared=True)``: in
    float64 chunks for float32 inputs (norms recomputed on the chunks), at
    once for float64 ones."""
    if X.dtype == np.float32 or Y.dtype == np.float32:
        out = np.empty((X.shape[0], Y.shape[0]), dtype=np.float32)
        size = _batch_size(X.shape[0], Y.shape[0], X.shape[1])
        for xs in _batches(X.shape[0], size):
            Xc = X[xs, :].astype(np.float64)
            XXc = row_norms(Xc)[:, None]
            for ys in _batches(Y.shape[0], size):
                Yc = Y[ys, :].astype(np.float64)
                d = -2 * (Xc @ Yc.T)
                d += XXc
                d += row_norms(Yc)[None, :]
                out[xs, ys] = d.astype(np.float32, copy=False)
    else:
        out = -2 * (X @ Y.T)
        out += row_norms(X)[:, None]
        out += np.reshape(Y_norm_squared, (1, -1))
    np.maximum(out, 0, out=out)
    return out


def kmeans_plusplus(
    X: np.ndarray,
    n_clusters: int,
    random_state: np.random.RandomState,
    x_squared_norms: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """k-means++ seeding with unit sample weights: ``(centers, indices)``."""
    n_samples, n_features = X.shape
    if x_squared_norms is None:
        x_squared_norms = row_norms(X)
    sample_weight = np.ones(n_samples, dtype=X.dtype)
    centers = np.empty((n_clusters, n_features), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = random_state.choice(n_samples, p=sample_weight / sample_weight.sum())
    indices = np.full(n_clusters, -1, dtype=int)
    centers[0] = X[center_id]
    indices[0] = center_id
    closest_dist_sq = squared_distances(centers[0, np.newaxis], X, x_squared_norms)
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = squared_distances(X[candidate_ids], X, x_squared_norms)
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        best = candidate_ids[best]
        centers[c] = X[best]
        indices[c] = best
    return centers, indices


# -- Lloyd ---------------------------------------------------------------------------


def _gemm(dtype):
    from scipy.linalg import blas

    return blas.sgemm if dtype == np.float32 else blas.dgemm


def _assign(X: np.ndarray, centers: np.ndarray, labels: np.ndarray) -> None:
    """Each sample's first closest centre by ``|c|^2 - 2 x.c``, chunk by
    chunk, through the BLAS call ``_update_chunk_dense`` makes (row-major
    ``C = -2 X C^T + C`` as the column-major ``gemm('T', 'N')``)."""
    gemm = _gemm(X.dtype)
    c_sq = row_norms(centers)
    n = X.shape[0]
    step = CHUNK_SIZE if n > CHUNK_SIZE else n
    for start in range(0, n, step):
        Xc = X[start : start + step]
        dist = np.empty((Xc.shape[0], centers.shape[0]), dtype=X.dtype)
        dist[:] = c_sq
        dist = gemm(-2.0, centers.T, Xc.T, beta=1.0, c=dist.T, trans_a=1, overwrite_c=1).T
        labels[start : start + step] = np.argmin(dist, axis=1)


def _squared_rows(X: np.ndarray, centers: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """``_euclidean_dense_dense(x, c, squared=True)`` per sample, in X's
    dtype: four features at a time, then the rest one by one."""
    diff = X - centers[labels]
    sq = diff * diff
    f = X.shape[1]
    out = np.zeros(X.shape[0], dtype=X.dtype)
    for i in range(f // 4):
        q = sq[:, 4 * i : 4 * i + 4]
        out += ((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]
    for k in range(f - f % 4, f):
        out += sq[:, k]
    return out


def _inertia(X, centers, labels) -> np.floating:
    return np.cumsum(_squared_rows(X, centers, labels), dtype=X.dtype)[-1]


def _lloyd_step(X, centers_old, labels) -> Tuple[np.ndarray, np.ndarray]:
    """One E and M step: ``labels`` in place; the new centres and each
    centre's shift."""
    _assign(X, centers_old, labels)
    K, f = centers_old.shape
    centers_new = np.zeros((K, f), dtype=X.dtype)
    weight = np.zeros(K, dtype=X.dtype)
    np.add.at(centers_new, labels, X)
    np.add.at(weight, labels, X.dtype.type(1))
    empty = np.where(np.equal(weight, 0))[0]
    if len(empty):
        dist = ((X - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[: -len(empty) - 1 : -1]
        if np.max(dist) != 0:
            for new, i in zip(empty, far):
                old = labels[i]
                centers_new[old] -= X[i]
                centers_new[new] = X[i]
                weight[new] = 1
                weight[old] -= 1
    heaviest = np.argmax(weight)
    for j in range(K):
        if weight[j] > 0:
            centers_new[j] *= X.dtype.type(1.0 / np.float64(weight[j]))
        else:
            centers_new[j] = centers_new[heaviest]
    shift = np.sqrt(_squared_rows(centers_new, centers_old, np.arange(K)))
    return centers_new, shift.astype(X.dtype)


def _lloyd(X, centers_init, max_iter: int, tol) -> Tuple[np.ndarray, np.floating]:
    """``_kmeans_single_lloyd``: ``(labels, inertia)``."""
    centers = centers_init
    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(max_iter):
        centers_new, shift = _lloyd_step(X, centers, labels)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift**2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        _assign(X, centers, labels)
    return labels, _inertia(X, centers, labels)


def _same_clustering(a: np.ndarray, b: np.ndarray, n_clusters: int) -> bool:
    """Whether ``a`` and ``b`` agree up to a relabelling of ``a``'s labels."""
    mapping = np.full(n_clusters, -1, dtype=np.int32)
    for x, y in zip(a.tolist(), b.tolist()):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


def kmeans(X, n_clusters: int, random_state: int = 0, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4) -> np.ndarray:
    """``KMeans(n_clusters, random_state=random_state, n_init=n_init).fit(X)
    .labels_`` (int32)."""
    X = _as_float(X)
    tol = np.mean(np.var(X, axis=0)) * tol
    X -= X.mean(axis=0)
    x_squared_norms = row_norms(X)
    rs = np.random.RandomState(random_state)
    best_inertia, best_labels = None, None
    for _ in range(n_init):
        centers, _ = kmeans_plusplus(X, n_clusters, rs, x_squared_norms)
        labels, inertia = _lloyd(X, centers, max_iter, tol)
        if best_inertia is None or (
            inertia < best_inertia and not _same_clustering(labels, best_labels, n_clusters)
        ):
            best_labels, best_inertia = labels, inertia
    return best_labels


# -- GaussianMixture --------------------------------------------------------------


def _gaussian_parameters(X, resp, reg_covar: float):
    nk = np.sum(resp, axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, np.newaxis]
    K, f = means.shape
    covariances = np.empty((K, f, f), dtype=X.dtype)
    for k in range(K):
        diff = X - means[k, :]
        covariances[k, :, :] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        covariances[k].flat[: f * f : f + 1] += np.asarray(reg_covar, dtype=X.dtype)
    return nk, means, covariances


def _precision_cholesky(covariances: np.ndarray) -> np.ndarray:
    from scipy.linalg import cholesky, solve_triangular

    K, f, _ = covariances.shape
    out = np.empty((K, f, f), dtype=covariances.dtype)
    for k in range(K):
        try:
            chol = cholesky(covariances[k, :, :], lower=True)
        except np.linalg.LinAlgError as exc:
            raise ValueError(
                "Fitting the mixture model failed because some components have ill-defined "
                "empirical covariance (for instance caused by singleton or collapsed samples)."
            ) from exc
        out[k, :, :] = solve_triangular(chol, np.eye(f, dtype=covariances.dtype), lower=True).T
    return out


def _weighted_log_prob(X, weights, means, precisions_chol) -> np.ndarray:
    n, f = X.shape
    K = means.shape[0]
    log_det = np.sum(np.log(np.reshape(precisions_chol, (K, -1))[:, :: f + 1]), axis=1)
    log_prob = np.empty((n, K), dtype=X.dtype)
    for k in range(K):
        prec = precisions_chol[k, :, :]
        y = (X @ prec) - (means[k, :] @ prec)
        log_prob[:, k] = np.sum(np.square(y), axis=1)
    return -0.5 * (f * math.log(2 * math.pi) + log_prob) + log_det + np.log(weights)


def _logsumexp_rows(a: np.ndarray) -> np.ndarray:
    """scikit-learn's ``_logsumexp(a, axis=1)``."""
    amax = np.max(a, axis=1, keepdims=True)
    at_max = a == amax
    a = np.array(a, copy=True)
    a[at_max] = -np.inf
    m = np.sum(at_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(amax), amax, 0)
    s = np.sum(np.exp(a - shift), axis=1, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + amax, axis=1)


def gaussian_mixture_labels(X, n_components: int, random_state: int = 0, reg_covar: float = 1e-6,
                            tol: float = 1e-3, max_iter: int = 100) -> np.ndarray:
    """``GaussianMixture(n_components, random_state=random_state,
    init_params="k-means++").fit(X).predict(X)``."""
    X = _as_float(X)
    n = X.shape[0]
    rs = np.random.RandomState(random_state)
    resp = np.zeros((n, n_components), dtype=X.dtype)
    _, indices = kmeans_plusplus(X, n_components, rs)
    resp[indices, np.arange(n_components)] = 1
    weights, means, cov = _gaussian_parameters(X, resp, reg_covar)
    weights /= n
    prec = _precision_cholesky(cov)
    lower_bound = -np.inf
    for _ in range(max_iter):
        previous = lower_bound
        wlp = _weighted_log_prob(X, weights, means, prec)
        log_norm = _logsumexp_rows(wlp)
        with np.errstate(under="ignore"):
            log_resp = wlp - log_norm[:, np.newaxis]
        weights, means, cov = _gaussian_parameters(X, np.exp(log_resp), reg_covar)
        weights /= np.sum(weights)
        prec = _precision_cholesky(cov)
        lower_bound = np.mean(log_norm)
        if abs(lower_bound - previous) < tol:
            break
    return np.argmax(_weighted_log_prob(X, weights, means, prec), axis=1)
