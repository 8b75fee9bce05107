"""Pods: the sharded step in several processes over ``torch.distributed``.

Counterpart of ``hyper_graph_nets_tpu/parallel/multihost.py``.  Every
process runs the same program, as every host of a TPU pod slice does:

1. ``torch.distributed.init_process_group(backend, init_method=
   "tcp://<host>:<port>", world_size=P, rank=p)`` (the caller's; nothing
   here reads a cluster's environment);
2. :func:`make_pod_group`: the pod laid out as JAX's ``make_pod_mesh`` lays
   its mesh: ``graph = graph_per_host`` (default: a process's ranks),
   ``data = P * n_local // graph``, the ranks numbered process-major and
   laid out row-major over ``(data, graph)``, those past ``data * graph``
   idle; a ``parallel.group.RankGroup`` of this process's ranks.  With
   ``graph`` at most a process's ranks each ``graph`` row stays in one
   process and only the ``data`` sums (the normalizers' statistics, the
   loss, the gradients) cross; with more, a ``graph`` row spans processes,
   and the edge shards' sums cross too: K1 raw and K2 per shard with the
   plain all-reduce over the processes, or the ring kernels K6 (the halo
   forward's ``ring``) and K7 (``shard_topology(overlap_bands=...)``), each
   process launching its own ranks' kernels, which write into their
   neighbours in the other processes through CUDA IPC (the row's processes
   on one node; across nodes they raise: ROADMAP entry 7.4d);
3. each process loads its trajectories (:func:`host_trajectory_indices`)
   and hands the frames of its ``data`` rows to the step
   (:func:`host_local_batch_to_global`): processes that share a row pass
   the same frames, as ``jax.make_array_from_process_local_data`` takes
   them.

The backend decides where the processes' sums run: ``nccl`` on the cards
(each process on cards of its own: NCCL refuses two processes on one
card), ``gloo`` through the host (processes may share a card).  Either
way each sum is an all-gather and a fold in global rank order, so every
process holds the bits of the in-process group of the same shape over the
same devices.  With no process group initialized, the process is a pod of
one: the same calls give the plain local group and batch.

Use::

    torch.distributed.init_process_group("nccl", init_method="tcp://127.0.0.1:29500",
                                         world_size=2, rank=p)
    group = make_pod_group(graph_per_host=2, devices=[f"cuda:{p}"])   # 1 x 2: graph across the two
    step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
    batch = host_local_batch_to_global(frames_of_this_row, group)
    tstate, loss = step(tstate, batch, generator=g)           # g seeded alike in every process
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
from hyper_graph_nets_tpu_torch.runtime import resolve_device


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The default process group's size (1 when none is initialized)."""
    if not _initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    """This process's rank in the default process group (0 when none)."""
    if not _initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def pod_layout(processes: int, process: int, n_local: int, graph_per_host: int = 0) -> Tuple[int, int, List[int]]:
    """``(data, graph, ranks)`` of ``make_pod_mesh``'s formula: ``graph =
    graph_per_host or n_local``, ``data = processes * n_local // graph``,
    and ``process``'s global ranks (``process * n_local + i``) below ``data
    * graph``; the port's extension for one process with ``graph`` above
    its ranks (where JAX's mesh would be empty): one row of ``graph`` ranks,
    which share the devices round-robin."""
    graph = graph_per_host or n_local
    if processes == 1 and graph > n_local:
        return 1, graph, list(range(graph))
    data = processes * n_local // graph
    if data == 0:
        raise ValueError(f"graph {graph} exceeds the pod's {processes} x {n_local} ranks")
    first = process * n_local
    ranks = [q for q in range(first, first + n_local) if q < data * graph]
    if not ranks:
        raise ValueError(f"process {process} holds no rank of the {data} x {graph} pod (its ranks would all sit out)")
    return data, graph, ranks


def make_pod_group(graph_per_host: int = 0, device=None, devices=None) -> RankGroup:
    """This process's ranks of the pod's ``(data, graph)`` group (the JAX
    package's ``make_pod_mesh``, :func:`pod_layout`): one local rank per
    entry of ``devices`` (a list; a device named twice stands in for two),
    or per card (``device`` None or a CUDA device), or the one CPU
    (``device="cpu"``).  Ranks past ``data * graph`` sit out, as JAX's
    devices past ``devices[: data * graph]`` do.  Over several devices the
    sharded step keeps a parameter copy on each and sums their gradients
    with the other processes' devices', in global order."""
    if devices is None:
        base = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if base.type == "cuda" else [base])
    elif device is not None:
        raise ValueError("pass devices or device, not both")
    n_local = len(devices)
    data, graph, ranks = pod_layout(process_count(), process_index(), n_local, graph_per_host)
    pg = None
    if _initialized():
        import torch.distributed as dist

        pg = dist.group.WORLD
    if len(ranks) > n_local:  # one process, graph above its ranks: round-robin
        per, local = len(ranks), [devices[q % n_local] for q in ranks]
    else:
        per, local = n_local, [devices[q - process_index() * n_local] for q in ranks]
    return RankGroup(data, graph, devices=local, process_group=pg, ranks=ranks, per_process=per)


def host_local_batch_to_global(frames: Dict[str, np.ndarray], group: RankGroup) -> Dict[str, torch.Tensor]:
    """This process's frames on the group's device: the frames of its
    ``data`` rows (``group.data_rows``), ``B_row`` a row, one after another
    (what ``jax.make_array_from_process_local_data`` takes: processes that
    share a row pass the same frames).  The global batch is ``B_row x
    data``; the sharded step reads the rows from the group, cuts the global
    noise draws at them, and sums the normalizers, the loss and the
    gradients over the whole batch."""
    dev = group.device(0)
    out = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(dev)
           for k, v in frames.items()}
    rows = len(group.data_rows)
    for k, v in out.items():
        if v.shape[0] % rows:
            raise ValueError(f"{k}: {v.shape[0]} frames do not split over this process's {rows} data rows")
    return out


def host_trajectory_indices(num_trajectories: int) -> range:
    """This process's trajectories, dealt round-robin over the processes."""
    return range(process_index(), num_trajectories, process_count())

