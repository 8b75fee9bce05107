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
cotangents`` returning this process's own); with ``raises``, the ring
kernels' entries (K7's layout, K6 through the halo forward, the ring
aggregate and the ring all-reduce), each of which must raise.  It saves,
per case, its layout, loss, gradients, parameters after Adam, normalizer
states and forward rows.

Run: torch_port_pod_graph_worker.py <rank> <world size> <port> <input.pt> <output.pt>
"""
import os
import sys
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hyper_graph_nets_tpu_torch.core.segment_ops import collective_aggregate  # noqa: E402
from hyper_graph_nets_tpu_torch.models.get_model import get_model  # noqa: E402
from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel import multihost  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel.halo import make_halo_forward  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel.sharding import (  # noqa: E402
    make_sharded_forward,
    make_spmd_train_step,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer  # noqa: E402

NORMALIZER_FIELDS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def start_state(trainer, case):
    """A train state of the case's parameters and normalizers."""
    state = trainer.model.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(case["params"][n])
    return trainer.init_train_state(state=state.replace(normalizers=case["normalizers"]))


def ring_errors(model, topo, group):
    """The message of each ring kernel's entry on this group (None where one
    did not raise)."""
    x = torch.zeros(topo.senders.shape[0] // group.shape["graph"], 4)
    rcv = topo.receivers[: x.shape[0]]
    entries = {
        "overlap_layout": lambda: shard_topology(topo, group, overlap_bands=4),
        "halo_ring": lambda: make_halo_forward(model, group, ring=True),
        "ring_aggregate": lambda: group.run(
            lambda r: collective_aggregate(x, rcv, topo.num_nodes, "pna", None, group, ring=True)),
        "ring_all_reduce": lambda: ring_all_reduce_segments([torch.zeros(8, 4)] * group.n, [(0, 8, "sum")], group),
    }
    out = {}
    for name, fn in entries.items():
        try:
            fn()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
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
    if case.get("raises"):
        out["ring_errors"] = ring_errors(model, topo, group)
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
        results = {name: run_case(case, pod) for name, case in job["cases"].items()}
        torch.save(results, dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
