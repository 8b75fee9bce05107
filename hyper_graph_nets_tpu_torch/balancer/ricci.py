"""Ricci (SDRF) graph balancer: stochastic discrete Ricci flow rewiring.

Counterpart of ``hyper_graph_nets_tpu/balancer/ricci.py``:

- the balanced-Forman curvature of every edge from three {0,1} count
  products (``A @ A``, ``P @ A``, ``A @ P``: exact in float32, plain
  ``torch.matmul``) and two (max, x) semiring products through K5
  (``ops/maxprod.py``);
- ``post_delta``, the curvature of each candidate edge after adding it,
  vectorised over the ``[ni, nj, N]`` grid of candidates and nodes;
- the SDRF decision loop on the host (the argmin edge, softmax sampling of
  the improvement, optional removal of the most curved edge), with the same
  ``np.random.RandomState`` draws, so the port adds and removes the same
  edges as the JAX package.

Every elementwise step is the JAX function's, in its order, each rounded
once, so the curvature agrees bit for bit and ties break alike.  The
adjacency lives on the topology's device; each loop reads back its extrema
in one transfer and the candidate deltas in another.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod

MaxProd = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _curvature_and_square(A: torch.Tensor, maxprod_fn: MaxProd) -> Tuple[torch.Tensor, torch.Tensor]:
    A = A.to(torch.float32)
    A2 = A @ A
    d = A.sum(dim=1)  # undirected: d_in == d_out
    d_max = torch.maximum(d[:, None], d[None, :])
    d_min = torch.minimum(d[:, None], d[None, :])

    B = torch.clamp(A2 - A, min=0.0)  # common-neighbour excess
    P = (B > 0).to(torch.float32)
    sharp = P @ A + A @ P
    lam = torch.maximum(maxprod_fn(B, A), maxprod_fn(A, B))

    safe_dmax = torch.clamp(d_max, min=1.0)
    safe_dmin = torch.clamp(d_min, min=1.0)
    base = (
        2.0 / safe_dmax
        + 2.0 / safe_dmin
        - 2.0
        + (2.0 / safe_dmax + 1.0 / safe_dmin) * A2 * A
    )
    C = base + torch.where(lam > 0, sharp / (safe_dmax * torch.clamp(lam, min=1e-30)), 0.0)
    C = torch.where((A > 0) & (d_max * d_min > 0), C, 0.0)
    return C, A2


def balanced_forman_curvature(A: torch.Tensor, maxprod_fn: MaxProd = maxprod) -> torch.Tensor:
    """``C[i, j]`` for every edge of the symmetric 0/1 adjacency ``A``; 0
    elsewhere.  ``maxprod_fn`` is K5's wrapper (or its plain version)."""
    return _curvature_and_square(A, maxprod_fn)[0]


def balanced_forman_post_delta(
    A: torch.Tensor,
    A2: torch.Tensor,
    x: int,
    y: int,
    i_nbrs: torch.Tensor,
    j_nbrs: torch.Tensor,
) -> torch.Tensor:
    """Curvature of edge (x, y) after adding each candidate edge (i, j),
    ``[ni, nj]``; ``i_nbrs``/``j_nbrs`` are int tensors padded with -1, and
    a padded or existing candidate gives -1000."""
    A = A.to(torch.float32)
    n = A.shape[0]
    d_in_x = A[:, x].sum()
    d_out_y = A[y, :].sum()
    Axy = A[x, y]

    i_valid = i_nbrs >= 0
    j_valid = j_nbrs >= 0
    i = torch.where(i_valid, i_nbrs, 0).long()
    j = torch.where(j_valid, j_nbrs, 0).long()

    ii = i[:, None]  # [ni, 1]
    jj = j[None, :]  # [1, nj]
    invalid = (ii == jj) | (A[ii, jj] != 0) | ~i_valid[:, None] | ~j_valid[None, :]

    # degree adjustment: if j == x: d_in_x += 1 elif i == y: d_out_y += 1
    dx = d_in_x + (jj == x).to(torch.float32)
    dy = torch.where(jj == x, d_out_y, d_out_y + ((ii == y) & (jj != x)).to(torch.float32))
    dmax = torch.maximum(dx, dy)
    dmin = torch.minimum(dx, dy)

    # triangle adjustment (the same elif chain as the reference)
    cond1 = (x == ii) & (A[jj, y] != 0)
    cond2 = (y == jj) & (A[x, ii] != 0) & ~cond1
    A2xy = A2[x, y] + torch.where(cond1, A[jj, y], 0.0) + torch.where(cond2, A[x, ii], 0.0)

    # four-cycle terms over z (broadcast [ni, nj, N])
    zi = torch.arange(n, device=A.device)[None, None, :]
    i3 = ii[:, :, None]
    j3 = jj[:, :, None]
    f32 = lambda t: t.to(torch.float32)
    A_z_y = A[:, y][None, None, :] + f32((zi == i3) & (j3 == y))
    A_x_z = A[x, :][None, None, :] + f32((x == i3) & (zi == j3))
    A2_z_y = (
        A2[:, y][None, None, :]
        + torch.where((zi == i3) & (A[j3, y] != 0), A[j3, y], 0.0)
        + torch.where((j3 == y) & (A[zi, i3] != 0), A[zi, i3], 0.0)
    )
    A2_x_z = (
        A2[x, :][None, None, :]
        + torch.where((x == i3) & (A[j3, zi] != 0), A[j3, zi], 0.0)
        + torch.where((zi == j3) & (A[x, i3] != 0), A[x, i3], 0.0)
    )

    tmp1 = A_z_y * (A2_x_z - A_x_z) * Axy
    tmp2 = A_x_z * (A2_z_y - A_z_y) * Axy
    sharp = f32(tmp1 > 0).sum(dim=-1) + f32(tmp2 > 0).sum(dim=-1)
    lam = torch.maximum(tmp1.amax(dim=-1), tmp2.amax(dim=-1))
    lam = torch.clamp(lam, min=0.0)

    safe_dmax = torch.clamp(dmax, min=1.0)
    safe_dmin = torch.clamp(dmin, min=1.0)
    D = (
        2.0 / safe_dmax
        + 2.0 / safe_dmin
        - 2.0
        + (2.0 / safe_dmax + 1.0 / safe_dmin) * A2xy * Axy
    )
    D = D + torch.where(lam > 0, sharp / (safe_dmax * torch.clamp(lam, min=1e-30)), 0.0)
    D = torch.where(dx * dy == 0, 0.0, D)
    return torch.where(invalid, -1000.0, D)


def _softmax(a: np.ndarray, tau: float) -> np.ndarray:
    e = np.exp((a - a.max()) * tau)
    return e / e.sum()


def _pad_pow2(lst, fill=-1) -> np.ndarray:
    n = max(len(lst), 1)
    p = 1
    while p < n:
        p *= 2
    return np.asarray(list(lst) + [fill] * (p - len(lst)), np.int32)


def sdrf(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    loops: int = 10,
    remove_edges: bool = False,
    removal_bound: float = 0.5,
    tau: float = 1.0,
    seed: int = 0,
    device="cpu",
    maxprod_fn: MaxProd = maxprod,
) -> Tuple[Dict[str, list], Optional[Dict[str, list]]]:
    """Stochastic Discrete Ricci Flow on the undirected graph of
    ``(senders, receivers)``, with the adjacency on ``device``.

    Returns ``({'senders', 'receivers'} added, removed or None)``: both
    directions of each rewired edge, as the JAX package's ``sdrf``.
    ``sdrf.loops_run`` holds the number of loops the last call ran.
    """
    rng = np.random.RandomState(seed)
    A_host = np.zeros((num_nodes, num_nodes), np.float32)
    A_host[senders, receivers] = 1.0
    A_host[receivers, senders] = 1.0
    np.fill_diagonal(A_host, 0.0)
    nbrs = [set(np.nonzero(A_host[i])[0].tolist()) for i in range(num_nodes)]
    A = torch.from_numpy(A_host).to(device)

    added = {"senders": [], "receivers": []}
    removed = {"senders": [], "receivers": []}

    sdrf.loops_run = 0
    for _ in range(loops):
        sdrf.loops_run += 1
        can_add = True
        C, A2 = _curvature_and_square(A, maxprod_fn)
        # the first minimal and maximal entries and their values, in one read
        ix = torch.stack([C.argmin(), C.argmax()])
        ix_min, ix_max, c_min, c_max = torch.cat([ix.double(), C.view(-1)[ix].double()]).tolist()
        ix_min, ix_max = int(ix_min), int(ix_max)
        x, y = ix_min // num_nodes, ix_min % num_nodes

        x_nbrs = sorted(nbrs[x]) + [x]
        y_nbrs = sorted(nbrs[y]) + [y]
        candidates = [
            (i, j)
            for i in x_nbrs
            for j in y_nbrs
            if i != j and j not in nbrs[i]
        ]
        if candidates:
            D = balanced_forman_post_delta(
                A, A2, x, y,
                torch.from_numpy(_pad_pow2(x_nbrs)).to(device),
                torch.from_numpy(_pad_pow2(y_nbrs)).to(device),
            )
            D_host = D.cpu().numpy()
            c_xy = c_min  # C[x, y]
            improvements = np.array(
                [
                    D_host[x_nbrs.index(i), y_nbrs.index(j)] - c_xy
                    for (i, j) in candidates
                ]
            )
            k, l = candidates[rng.choice(len(candidates), p=_softmax(improvements, tau))]
            nbrs[k].add(l)
            nbrs[l].add(k)
            added["senders"].extend([k, l])
            added["receivers"].extend([l, k])
            A[k, l] = 1.0
            A[l, k] = 1.0
        else:
            can_add = False
            if not remove_edges:
                break

        if remove_edges:
            xr, yr = ix_max // num_nodes, ix_max % num_nodes
            if c_max > removal_bound and yr in nbrs[xr]:  # c_max = C[xr, yr]
                nbrs[xr].discard(yr)
                nbrs[yr].discard(xr)
                removed["senders"].extend([xr, yr])
                removed["receivers"].extend([yr, xr])
                A[xr, yr] = 0.0
                A[yr, xr] = 0.0
            else:
                if not can_add:
                    break

    return added, (removed if remove_edges else None)


sdrf.loops_run = 0


class Ricci:
    """The SDRF balancer algorithm, configured from ``model.graph_balancer``."""

    def __init__(self, params: dict):
        bal = params["model"]["graph_balancer"]
        ricci_cfg = bal.get("ricci", {})
        self.loops = ricci_cfg.get("loops", 150)
        self.tau = ricci_cfg.get("tau", 150)
        self.remove_edges = bal.get("remove_edges", True)

    def run(self, topo) -> Tuple[Dict[str, list], Optional[Dict[str, list]]]:
        """SDRF on the topology's mesh, on the topology's device."""
        return sdrf(
            topo.senders.cpu().numpy(),
            topo.receivers.cpu().numpy(),
            topo.num_nodes,
            loops=self.loops,
            remove_edges=self.remove_edges,
            tau=self.tau,
            device=topo.senders.device,
        )
