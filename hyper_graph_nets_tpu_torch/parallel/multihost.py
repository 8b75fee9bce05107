"""Pods: the sharded step in several processes over ``torch.distributed``.

Counterpart of ``hyper_graph_nets_tpu/parallel/multihost.py``.  Every
process runs the same program, as every host of a TPU pod slice does:

1. ``torch.distributed.init_process_group("gloo", init_method=
   "tcp://<host>:<port>", world_size=P, rank=p)`` (the caller's; nothing
   here reads a cluster's environment);
2. :func:`make_pod_group`: a ``parallel.group.RankGroup`` of the process's
   own ranks, ``data`` across the processes and ``graph`` within each one,
   so that the edge shards' collectives (and every ring kernel) stay in the
   process and only the ``data`` axis (the normalizers' statistics, the loss
   and the gradients) crosses between processes, through the host;
3. each process loads its own trajectories (:func:`host_trajectory_indices`)
   and hands its ``[B_local, ...]`` frames to the step as one slice of the
   global batch (:func:`host_local_batch_to_global`).

With no process group initialized, the process is a pod of one: the same
calls give the plain local group and batch.  Two processes may share one
card: the ``gloo`` group combines through CPU tensors, where NCCL would
refuse two ranks on one card.  A process may hold several cards (the
default: every local one): the step sums their gradients in the process,
in device order, before the processes' sum.

Use::

    torch.distributed.init_process_group("gloo", init_method="tcp://127.0.0.1:29500",
                                         world_size=2, rank=p)
    group = make_pod_group(graph_per_host=2)                 # 1 x 2 here, 2 x 2 over the pod
    step = make_spmd_train_step(trainer, shard_topology(topo, group), group)
    batch = host_local_batch_to_global(frames_of_this_process, group)
    tstate, loss = step(tstate, batch, generator=g)           # g seeded alike in every process
"""
from __future__ import annotations

from typing import Dict

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


def make_pod_group(graph_per_host: int = 0, device=None, devices=None) -> RankGroup:
    """This process's ``data_local x graph`` ranks of the pod's ``(data,
    graph)`` group (the JAX package's ``make_pod_mesh``): one rank per local
    device, and at least ``graph`` ranks, which then share the devices
    round-robin; ``graph`` = ``graph_per_host`` (default: every local
    device), ``data_local`` = the local ranks // ``graph``, and the pod's
    ``data`` axis ``process_count() * data_local`` long.  The local devices
    are ``devices`` (a list), or every card (``device`` None or a CUDA
    device), or the one CPU (``device="cpu"``).  With several, the sharded
    step keeps a parameter copy on each and sums their gradients before the
    processes' sum."""
    if devices is None:
        base = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if base.type == "cuda" else [base])
    elif device is not None:
        raise ValueError("pass devices or device, not both")
    cards = len(devices)
    graph = graph_per_host or cards
    local = max(cards, graph)
    if local % graph:
        raise ValueError(f"{local} ranks per process do not split into graph rows of {graph}")
    pg = None
    if _initialized():
        import torch.distributed as dist

        pg = dist.group.WORLD
    return RankGroup(local // graph, graph, devices=[devices[r % cards] for r in range(local)], process_group=pg)


def host_local_batch_to_global(frames: Dict[str, np.ndarray], group: RankGroup) -> Dict[str, torch.Tensor]:
    """This process's ``[B_local, ...]`` frames on the group's device: its
    slice of the global batch ``[B_local * process_count, ...]``, rows
    ``B_local * process_index ..`` (every process passes the same
    ``B_local``).  The sharded step reads the slice from the group: it cuts
    the global noise draws at those rows, and the normalizers, the loss and
    the gradients sum over the whole batch."""
    dev = group.device(0)
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(dev)
            for k, v in frames.items()}


def host_trajectory_indices(num_trajectories: int) -> range:
    """This process's trajectories, dealt round-robin over the processes."""
    return range(process_index(), num_trajectories, process_count())

