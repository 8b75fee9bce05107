"""One process of a pod of the port whose ``graph`` rows span processes
(tests/test_torch_port_pod_graph.py starts them on the CPU over ``gloo``,
tests/test_torch_port_cuda.py over ``nccl`` with a card a process; pytest
does not collect this file).

The process joins the job's process group over TCP (``nccl``: with its
first device as its current card), builds its share of the pod
(``parallel.multihost.make_pod_group(graph_per_host=G, devices=...)``, the
job's devices for this process), and runs each case of the job in turn: the
sharded forward and one sharded train step on the frames of its ``data``
rows (``host_local_batch_to_global``), with the global noise handed in;
with ``control``, the step again with the other processes' aggregate
cotangents dropped from every sharded node's backward (``RankGroup.
cotangents`` returning this process's own).  It saves, per case, its
layout, loss, gradients, parameters after Adam, normalizer states and
forward rows.  A job's ``ring`` case (:func:`ring_case`) runs the ring
kernels' entries along the pod's rows instead: K6 (``ring_all_reduce_
segments``), the ring aggregate, K7's layout, the halo forward with
``ring`` and with ``overlap``, and the overlap-banded train step.

Run: torch_port_pod_graph_worker.py <rank> <world size> <port> <input.pt> <output.pt>
"""
import os
import sys
from datetime import timedelta

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hyper_graph_nets_tpu_torch.core.segment_ops import collective_aggregate  # noqa: E402
from hyper_graph_nets_tpu_torch.models.get_model import get_model  # noqa: E402
from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap  # noqa: E402
from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel import multihost  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward, split_graph  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel.sharding import (  # noqa: E402
    make_sharded_forward,
    make_spmd_train_step,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer  # noqa: E402

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")
RING_SEGMENTS = [(0, 4, "sum"), (4, 8, "max"), (8, 12, "min"), (12, 13, "sum")]
HALO_PATHS = {"halo_ring": ("xla", True, False), "halo_overlap": ("fused", False, True)}
BANDS = 4


def model_state(model, case):
    """A model state of the case's parameters and normalizers."""
    state = model.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(case["params"][n])
    return state.replace(normalizers=case["normalizers"])


def start_state(trainer, case):
    """A train state of the case's parameters and normalizers."""
    return trainer.init_train_state(state=model_state(trainer.model, case))


def ring_payload(q: int, rows: int = 13, cols: int = 5) -> torch.Tensor:
    """Global rank q's K6 partial (seeded by q)."""
    return torch.from_numpy(np.random.default_rng(100 + q).standard_normal((rows, cols)).astype(np.float32))


def by_rank(group, tensors):
    """``{global rank: tensor on the CPU}`` of this process's ranks."""
    return {q: t.cpu() for q, t in zip(group.ranks, tensors)}


def ring_case(case, make_group):
    """The ring kernels' entries along the rows of ``make_group()``'s group
    (a pod's share, or the in-process group of the same shape: the tests'
    reference), each result keyed by global rank: K6 on seeded partials
    (``k6``), the pna ring aggregate of seeded edge features over the
    rank's slice of receivers (``aggregate``), K7's layout (``layout``:
    each rank's edges and work list), the halo forward's rows with ``ring``
    (``halo_ring``) and ``overlap`` (``halo_overlap``) on frame 0, and one
    overlap-banded train step's loss and gradients (``step``); the K6 and
    K7 launches of this process (``launches``: none on the CPU)."""
    group = make_group()
    dev = group.device(0)
    out = dict(layout=dict(shape=group.shape, ranks=group.ranks, processes=group.processes))
    launched = (ring_all_reduce_segments.launches, fused_edge_block_overlap.launches)
    xs = [ring_payload(q).to(group.device(r)) for r, q in enumerate(group.ranks)]
    group.synchronize()  # the partials ready for the ranks' streams; the results read after the check
    k6 = ring_all_reduce_segments(xs, RING_SEGMENTS, group)
    group.check()
    out["k6"] = by_rank(group, k6)

    models = {agg: get_model(case["configs"][agg]) for agg in ("xla", "fused")}
    topos = {agg: m.topology_from_trajectory(case["trajectory"], device=dev) for agg, m in models.items()}
    N, G = topos["xla"].num_nodes, group.shape["graph"]
    per = -(-topos["xla"].senders.shape[0] // G)
    rcv = torch.cat([topos["xla"].receivers, topos["xla"].receivers.new_full((per * G,), N - 1)])

    def aggregate(r):  # whole numbers: the local sums exact in any order (index_add_ on a card adds atomically)
        q, k = group.ranks[r], group.axis_index(r, "graph")
        x = torch.from_numpy(np.random.default_rng(200 + q).integers(-8, 9, (per, 4)).astype(np.float32))
        return collective_aggregate(x.to(group.device(r)), rcv[k * per : (k + 1) * per].to(group.device(r)), N,
                                    "pna", None, group, ring=True)

    out["aggregate"] = by_rank(group, group.run(aggregate))

    banded = shard_topology(topos["fused"], group, overlap_bands=BANDS)
    out["layout"].update(
        senders=banded.senders.cpu(), receivers=banded.receivers.cpu(), mask=banded.mask.cpu(),
        work={q: [getattr(banded.plan.plans[r].overlap, f).cpu() for f in ("row_ptr", "groups", "group_edges")]
              for r, q in enumerate(group.ranks)})
    frame = {k: torch.as_tensor(v[0]).to(dev) for k, v in case["trajectory"].items() if k != "cells"}
    for path, (agg, ring, overlap) in HALO_PATHS.items():
        model = models[agg]
        stopo = banded if overlap else shard_topology(topos[agg], group)
        state = model_state(model, case).to(dev)
        with torch.no_grad():
            graph, _, _ = model.make_graph(state, stopo, frame, False)
        fwd = make_halo_forward(model, group, ring=ring, overlap=overlap)
        out[path] = by_rank(group, fwd(state, split_graph(graph, group), all_ranks=True))

    trainer = Trainer(models["fused"], case["configs"]["fused"], device=dev)
    frames = trainer.frames(case["frames"])
    rows = group.data_rows
    b = next(iter(frames.values())).shape[0] // group.shape["data"]
    batch = multihost.host_local_batch_to_global(
        {k: v[rows[0] * b : (rows[-1] + 1) * b] for k, v in frames.items()}, group)
    step = make_spmd_train_step(trainer, banded, group)
    tstate, loss = step(start_state(trainer, case), batch, normal=case["normal"])
    group.check()
    out["step"] = dict(loss=loss.cpu(), grads={n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()})
    out["launches"] = dict(K6=ring_all_reduce_segments.launches - launched[0],
                           K7=fused_edge_block_overlap.launches - launched[1])
    return out


def run_case(case, make_group):
    """One case on ``make_group()``'s group (a pod's share, or an in-process
    group: the tests' reference)."""
    group = make_group()
    model = get_model(case["config"])
    trainer = Trainer(model, case["config"], device=group.device(0))
    topo = model.topology_from_trajectory(case["trajectory"], device=group.device(0))
    static = None
    if trainer.expansion is not None:
        frame0 = {k: v[0] for k, v in case["trajectory"].items()}
        static = trainer.expansion.prepare(model, frame0, topo)
    frames = trainer.frames(case["frames"])
    rows = group.data_rows
    b = next(iter(frames.values())).shape[0] // group.shape["data"]
    batch = multihost.host_local_batch_to_global(
        {k: v[rows[0] * b : (rows[-1] + 1) * b] for k, v in frames.items()}, group)
    stopo = shard_topology(topo, group)
    kwargs = dict(normal=case["normal"], static=static, hyper_normal=case.get("hyper"))
    tstate = start_state(trainer, case)
    forward = make_sharded_forward(model, stopo, group, expansion=trainer.expansion)(tstate.model, batch,
                                                                                    static=static)
    step = make_spmd_train_step(trainer, stopo, group)
    tstate, loss = step(tstate, batch, **kwargs)
    group.check()
    out = dict(
        layout=dict(shape=group.shape, ranks=group.ranks, idle=group.idle, rows=rows, process=group.process,
                    processes=group.processes, devices=[str(d) for d in group.devices]),
        loss=loss.cpu(),
        forward=forward.cpu(),
        grads={n: p.grad.cpu() for n, p in tstate.model.params.named_parameters()},
        params={n: p.detach().cpu() for n, p in tstate.model.params.named_parameters()},
        normalizers={k: {f: getattr(v, f).cpu() for f in NORMALIZER_FIELDS}
                     for k, v in tstate.model.normalizers.items()},
    )
    if case.get("control"):
        group.cotangents = lambda parts, rank: list(parts)
        cstate = start_state(trainer, case)
        out["control_loss"] = step.loss_and_grads(cstate, batch, **kwargs)[0].cpu()
        out["control_grads"] = {n: p.grad.cpu() for n, p in cstate.model.params.named_parameters()}
    return out


def main(rank: int, world: int, port: int, src: str, dst: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(src, weights_only=False)
    devices = [torch.device(d) for d in job["devices"][rank]]
    backend = job.get("backend", "gloo")
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        pod = lambda: multihost.make_pod_group(graph_per_host=job["graph"], devices=devices)
        results = {name: run_case(case, pod) for name, case in job.get("cases", {}).items()}
        if "ring" in job:
            results["ring"] = ring_case(job["ring"], pod)
        torch.save(results, dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
