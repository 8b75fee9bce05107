"""HDBSCAN in numpy: mutual reachability, minimum spanning tree, single
linkage, the condensed tree, Excess-of-Mass selection and soft memberships.

Counterpart of ``hyper_graph_nets_tpu/rmp/hdbscan_tree.py``, step for step,
so that labels, exemplars and memberships come out the same.  A dense
O(N^2) Prim's tree: meshes here are a few thousand points.

Pipeline:
1. core distance  = distance to the min_samples-th nearest neighbour;
2. mutual reachability d_mr(a,b) = max(core_a, core_b, d(a,b));
3. the minimum spanning tree of the mutual-reachability graph, its edges
   sorted ascending;
4. the single-linkage dendrogram by union-find;
5. condense: children with < min_cluster_size points fall out of their
   parent at lambda = 1/distance; larger children become new clusters;
6. cluster stability = sum_p (lambda_p - lambda_birth);
7. Excess-of-Mass selection (children win when their stability sum reaches
   the parent's; clusters above max_cluster_size are not selectable);
8. labels from the selected clusters (noise = -1); exemplars = the points
   attached to each selected cluster's leaves at the leaf's largest lambda.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np


class CondensedTree(NamedTuple):
    parent: np.ndarray  # condensed node id (>= n) each row hangs from
    child: np.ndarray  # point id (< n) or condensed cluster id (>= n)
    lambda_val: np.ndarray  # 1/distance at which child separates
    child_size: np.ndarray  # points carried by the child


class HDBSCANResult(NamedTuple):
    labels: np.ndarray  # [n] int, -1 = noise
    probabilities: np.ndarray  # [n] in [0, 1]
    tree: CondensedTree
    selected: List[int]  # selected condensed cluster ids
    exemplars: List[List[int]]  # per selected cluster (label order)


def _mutual_reachability(X: np.ndarray, min_samples: int) -> np.ndarray:
    d = np.sqrt(
        np.maximum(
            np.sum(X**2, axis=1)[:, None]
            + np.sum(X**2, axis=1)[None, :]
            - 2 * X @ X.T,
            0.0,
        )
    )
    np.fill_diagonal(d, 0.0)
    k = min(max(min_samples, 1), len(X) - 1)
    core = np.partition(d, k, axis=1)[:, k]
    mr = np.maximum(np.maximum(core[:, None], core[None, :]), d)
    np.fill_diagonal(mr, 0.0)
    return mr


def _mst_edges(mr: np.ndarray) -> np.ndarray:
    """Prim's MST on the dense mutual-reachability matrix -> [n-1, 3]."""
    n = mr.shape[0]
    in_tree = np.zeros(n, bool)
    dist = np.full(n, np.inf)
    source = np.zeros(n, np.int64)
    in_tree[0] = True
    dist[:] = mr[0]
    dist[0] = np.inf
    edges = np.empty((n - 1, 3))
    for i in range(n - 1):
        v = int(np.argmin(dist))
        edges[i] = (source[v], v, dist[v])
        in_tree[v] = True
        better = mr[v] < dist
        better &= ~in_tree
        source[better] = v
        dist = np.where(better, mr[v], dist)
        dist[v] = np.inf
    order = np.argsort(edges[:, 2], kind="stable")
    return edges[order]


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(2 * n - 1, dtype=np.int64)
        self.size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
        self.next_label = n

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        label = self.next_label
        self.next_label += 1
        self.parent[a] = self.parent[b] = label
        self.size[label] = self.size[a] + self.size[b]
        return label


def _single_linkage(edges: np.ndarray, n: int) -> np.ndarray:
    """[n-1, 4] rows: (left, right, distance, size) with nodes >= n merged."""
    uf = _UnionFind(n)
    out = np.empty((n - 1, 4))
    for i, (a, b, dist) in enumerate(edges):
        ra, rb = uf.find(int(a)), uf.find(int(b))
        out[i] = (ra, rb, dist, uf.size[ra] + uf.size[rb])
        uf.union(ra, rb)
    return out


def _condense(linkage: np.ndarray, n: int, min_cluster_size: int) -> CondensedTree:
    root = 2 * n - 2
    parents: List[int] = []
    children: List[int] = []
    lambdas: List[float] = []
    sizes: List[int] = []

    # children lookup for dendrogram nodes
    left = np.full(2 * n - 1, -1, np.int64)
    right = np.full(2 * n - 1, -1, np.int64)
    dist_of = np.zeros(2 * n - 1)
    size_of = np.ones(2 * n - 1, np.int64)
    for i in range(n - 1):
        node = n + i
        left[node] = int(linkage[i, 0])
        right[node] = int(linkage[i, 1])
        dist_of[node] = linkage[i, 2]
        size_of[node] = int(linkage[i, 3])

    def node_points(node: int) -> List[int]:
        stack, pts = [node], []
        while stack:
            x = stack.pop()
            if x < n:
                pts.append(x)
            else:
                stack.extend((left[x], right[x]))
        return pts

    relabel = {root: n}
    next_label = n + 1
    stack = [root]
    while stack:
        node = stack.pop()
        current = relabel[node]
        # walk down through chains where one side is too small
        sub = node
        while True:
            l, r = left[sub], right[sub]
            lam = 1.0 / dist_of[sub] if dist_of[sub] > 0 else np.inf
            ls = size_of[l] if l >= 0 else 1
            rs = size_of[r] if r >= 0 else 1
            big_l = ls >= min_cluster_size
            big_r = rs >= min_cluster_size
            if big_l and big_r:
                for child in (l, r):
                    relabel[child] = next_label
                    parents.append(current)
                    children.append(next_label)
                    lambdas.append(lam)
                    sizes.append(int(size_of[child]))
                    next_label += 1
                    stack.append(child)
                break
            if not big_l and not big_r:
                for child in (l, r):
                    for p in node_points(child):
                        parents.append(current)
                        children.append(p)
                        lambdas.append(lam)
                        sizes.append(1)
                break
            # exactly one side survives: its points stay in `current`
            small, keep = (l, r) if big_r else (r, l)
            for p in node_points(small):
                parents.append(current)
                children.append(p)
                lambdas.append(lam)
                sizes.append(1)
            sub = keep
            if sub < n:
                # degenerate: surviving side is a single point
                parents.append(current)
                children.append(sub)
                lambdas.append(1.0 / dist_of[node] if dist_of[node] > 0 else np.inf)
                sizes.append(1)
                break

    return CondensedTree(
        parent=np.asarray(parents, np.int64),
        child=np.asarray(children, np.int64),
        lambda_val=np.asarray(lambdas),
        child_size=np.asarray(sizes, np.int64),
    )


def _stabilities(tree: CondensedTree, n: int) -> Dict[int, float]:
    births: Dict[int, float] = {}
    for c, lam in zip(tree.child, tree.lambda_val):
        if c >= n:
            births[int(c)] = min(births.get(int(c), np.inf), float(lam))
    births.setdefault(n, 0.0)
    stab: Dict[int, float] = {}
    for p, lam, size in zip(tree.parent, tree.lambda_val, tree.child_size):
        birth = births.get(int(p), 0.0)
        lamf = float(lam) if np.isfinite(lam) else birth
        stab[int(p)] = stab.get(int(p), 0.0) + (lamf - birth) * int(size)
    return stab


def _select_eom(
    tree: CondensedTree, n: int, max_cluster_size: Optional[int]
) -> List[int]:
    stab = _stabilities(tree, n)
    cluster_children: Dict[int, List[int]] = {}
    cluster_sizes: Dict[int, int] = {n: n}
    for p, c, size in zip(tree.parent, tree.child, tree.child_size):
        if c >= n:
            cluster_children.setdefault(int(p), []).append(int(c))
            cluster_sizes[int(c)] = int(size)

    selected: Dict[int, bool] = {}

    def walk(node: int) -> float:
        kids = cluster_children.get(node, [])
        if not kids:
            allowed = (
                max_cluster_size is None or cluster_sizes.get(node, 0) <= max_cluster_size
            )
            selected[node] = allowed
            return stab.get(node, 0.0) if allowed else 0.0
        child_total = sum(walk(k) for k in kids)
        own = stab.get(node, 0.0)
        too_big = (
            max_cluster_size is not None
            and cluster_sizes.get(node, 0) > max_cluster_size
        )
        if node == n or too_big or child_total >= own:
            selected[node] = False
            return child_total
        selected[node] = True
        # deselect all descendants
        stack = list(kids)
        while stack:
            k = stack.pop()
            selected[k] = False
            stack.extend(cluster_children.get(k, []))
        return own

    walk(n)
    return sorted(k for k, v in selected.items() if v)


def hdbscan_fit(
    X: np.ndarray,
    min_cluster_size: int = 5,
    min_samples: int = 1,
    max_cluster_size: Optional[int] = None,
) -> HDBSCANResult:
    X = np.asarray(X, float)
    n = len(X)
    if n < max(2 * min_cluster_size, 4):
        return HDBSCANResult(
            labels=np.zeros(n, int),
            probabilities=np.ones(n),
            tree=CondensedTree(
                np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64)
            ),
            selected=[],
            exemplars=[list(range(n))],
        )
    mr = _mutual_reachability(X, min_samples)
    linkage = _single_linkage(_mst_edges(mr), n)
    tree = _condense(linkage, n, min_cluster_size)
    selected = _select_eom(tree, n, max_cluster_size)

    # membership: the points reachable from a selected cluster without
    # crossing another selected cluster
    cluster_children: Dict[int, List[int]] = {}
    point_rows: Dict[int, List[int]] = {}
    for i, (p, c) in enumerate(zip(tree.parent, tree.child)):
        if c >= n:
            cluster_children.setdefault(int(p), []).append(int(c))
        else:
            point_rows.setdefault(int(p), []).append(i)

    labels = -np.ones(n, int)
    probabilities = np.zeros(n)
    exemplars: List[List[int]] = []
    selected_set = set(selected)
    for label, cluster in enumerate(selected):
        # collect this cluster's subtree (it has no selected descendants)
        nodes = [cluster]
        stack = [cluster]
        leaves = []
        while stack:
            x = stack.pop()
            kids = cluster_children.get(x, [])
            if not kids:
                leaves.append(x)
            stack.extend(kids)
            nodes.extend(kids)
        lam_max = 0.0
        member_rows = []
        for node in nodes:
            member_rows.extend(point_rows.get(node, []))
        lams = tree.lambda_val[member_rows]
        finite = lams[np.isfinite(lams)]
        lam_max = float(finite.max()) if len(finite) else 1.0
        for row in member_rows:
            p = int(tree.child[row])
            labels[p] = label
            lam = tree.lambda_val[row]
            probabilities[p] = (
                1.0 if not np.isfinite(lam) else min(lam / max(lam_max, 1e-12), 1.0)
            )
        # exemplars: per leaf, the points at that leaf's max lambda
        ex: List[int] = []
        for leaf in leaves:
            rows = point_rows.get(leaf, [])
            if not rows:
                continue
            lams = tree.lambda_val[rows]
            lmax = np.max(lams)
            ex.extend(int(tree.child[r]) for r, lv in zip(rows, lams) if lv >= lmax)
        exemplars.append(sorted(set(ex)))

    return HDBSCANResult(
        labels=labels,
        probabilities=probabilities,
        tree=tree,
        selected=selected,
        exemplars=exemplars,
    )


def membership_vectors(result: HDBSCANResult, X: np.ndarray) -> np.ndarray:
    """Per-point soft cluster memberships [n, K].

    The counterpart of the hdbscan package's
    ``all_points_membership_vectors``: the product of a *distance*
    component (inverse min distance to each cluster's exemplars) and an
    *outlier* component (the condensed-tree merge height of the point with
    each cluster over that cluster's max lambda), row-normalized.  The
    package's final ``prob_in_some_cluster`` scaling multiplies all of a
    row's entries equally and so cannot change the spotter metric
    ``1 - (p1-p2)/(p1+p2)``; it is left out.
    """
    n = len(X)
    K = len(result.selected)
    if K == 0:
        return np.zeros((n, 0))
    tree = result.tree

    # ---- distance component: 1 / min distance to exemplars ----------------
    dist = np.empty((n, K))
    for k, ex in enumerate(result.exemplars):
        if ex:
            dist[:, k] = np.min(
                np.linalg.norm(X[:, None, :] - np.asarray(X)[ex][None, :, :], axis=-1),
                axis=1,
            )
        else:
            dist[:, k] = np.inf
    dist_vec = 1.0 / np.maximum(dist, 1e-8)

    # ---- outlier component: merge heights in the condensed tree -----------
    # birth lambda and parent of every condensed cluster node
    birth: Dict[int, float] = {}
    parent_of: Dict[int, int] = {}
    for p, c, lam in zip(tree.parent, tree.child, tree.lambda_val):
        if c >= n:
            birth[int(c)] = float(lam)
            parent_of[int(c)] = int(p)
    root = int(tree.parent.min()) if len(tree.parent) else n
    birth.setdefault(root, 0.0)

    def path_to_root(node: int) -> List[int]:
        path = [node]
        while path[-1] in parent_of:
            path.append(parent_of[path[-1]])
        return path

    # max lambda per selected cluster (over its subtree's point rows)
    children: Dict[int, List[int]] = {}
    point_rows: Dict[int, List[int]] = {}
    for i, (p, c) in enumerate(zip(tree.parent, tree.child)):
        if c >= n:
            children.setdefault(int(p), []).append(int(c))
        else:
            point_rows.setdefault(int(p), []).append(i)

    def subtree(node: int) -> List[int]:
        out, stack = [node], [node]
        while stack:
            x = stack.pop()
            kids = children.get(x, [])
            out.extend(kids)
            stack.extend(kids)
        return out

    max_lambda = np.empty(K)
    subtree_sets = []
    for k, c in enumerate(result.selected):
        nodes = subtree(int(c))
        rows = [r for nd in nodes for r in point_rows.get(nd, [])]
        lams = tree.lambda_val[rows]
        finite = lams[np.isfinite(lams)]
        max_lambda[k] = float(finite.max()) if len(finite) else 1.0
        subtree_sets.append(set(nodes))

    cluster_paths = [path_to_root(int(c)) for c in result.selected]

    # per condensed node: merge lambda with each selected cluster
    node_merge: Dict[int, np.ndarray] = {}

    def merges_for(node: int) -> np.ndarray:
        if node in node_merge:
            return node_merge[node]
        path = path_to_root(node)
        path_set = set(path)
        out = np.empty(K)
        for k, cpath in enumerate(cluster_paths):
            if node in subtree_sets[k]:
                out[k] = np.inf  # own cluster: point's own lambda applies
                continue
            # lowest common ancestor: first node of cluster path in our path
            lca = next(x for x in cpath if x in path_set)
            # split lambda = birth of the cluster-side child of the LCA
            idx = cpath.index(lca)
            out[k] = birth[cpath[idx - 1]] if idx > 0 else birth.get(lca, 0.0)
        node_merge[node] = out
        return out

    point_parent = np.full(n, root, np.int64)
    point_lambda = np.zeros(n)
    for p, c, lam in zip(tree.parent, tree.child, tree.lambda_val):
        if c < n:
            point_parent[int(c)] = int(p)
            point_lambda[int(c)] = float(lam)

    outlier_vec = np.empty((n, K))
    for i in range(n):
        m = np.minimum(merges_for(int(point_parent[i])), point_lambda[i])
        outlier_vec[i] = np.minimum(m / np.maximum(max_lambda, 1e-12), 1.0)

    member = dist_vec * np.maximum(outlier_vec, 1e-12)
    member /= np.maximum(member.sum(axis=1, keepdims=True), 1e-12)
    return member
