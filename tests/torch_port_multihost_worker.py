"""One process of a two-process pod of the port on the CPU
(tests/test_torch_port_multihost.py starts two; pytest does not collect
this file).

The process joins a ``gloo`` process group over TCP, builds its ``1 x 2``
share of the ``2 x 2`` pod (``parallel.multihost.make_pod_group`` over two
local ranks that name the CPU twice, so that each process holds a row), takes
its half of the global batch (``host_local_batch_to_global``), runs the
sharded forward on it, one sharded train step with the global noise draw
handed in and one from the same state drawing it from a generator seeded
alike in both processes, then saves its forward rows, its loss, its
parameters after each step, its normalizer states, its group's layout
and devices, the step's parameter copies on its other devices, its
``host_trajectory_indices(10)``, and the gradients each step summed over
the pod before Adam.

With ``spread`` as a sixth argument, the process's group lies over two
logical devices (``cpu:0`` and ``cpu:1``, as a process with two cards
would hold it): the step keeps a parameter copy on the second.

Run: torch_port_multihost_worker.py <rank> <world size> <port> <input.pt> <output.pt> [spread]
"""
import os
import sys
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy  # noqa: E402
from hyper_graph_nets_tpu_torch.models.get_model import get_model  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel import multihost  # noqa: E402
from hyper_graph_nets_tpu_torch.parallel.sharding import (  # noqa: E402
    make_sharded_forward,
    make_spmd_train_step,
    shard_topology,
)
from hyper_graph_nets_tpu_torch.training.trainer import Trainer  # noqa: E402


def main(rank: int, world: int, port: int, src: str, dst: str, spread: bool = False) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        case = torch.load(src, weights_only=False)
        model = get_model(case["config"])
        trainer = Trainer(model, case["config"], device="cpu")
        topo = model.topology_from_trajectory(case["trajectory"], device="cpu")
        if spread:
            group = multihost.make_pod_group(devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
        else:
            group = multihost.make_pod_group(graph_per_host=2, devices=["cpu", "cpu"])
        frames = trainer.frames(case["frames"])
        b = next(iter(frames.values())).shape[0] // world
        batch = multihost.host_local_batch_to_global(
            {k: v[rank * b : (rank + 1) * b] for k, v in frames.items()}, group)
        stopo = shard_topology(topo, group)
        start = lambda: trainer.init_train_state(state=state_from_jax_numpy(*case["numpy_state"]))
        tstate = start()
        forward = make_sharded_forward(model, stopo, group)(tstate.model, batch)
        step = make_spmd_train_step(trainer, stopo, group)
        tstate, loss = step(tstate, batch, normal=case["normal"])
        grads = {n: p.grad.clone() for n, p in tstate.model.params.named_parameters()}
        drawn, _ = step(start(), batch, generator=torch.Generator().manual_seed(case["noise_seed"]))
        torch.save(dict(
            loss=loss,
            forward=forward,
            params={n: p.detach().clone() for n, p in tstate.model.params.named_parameters()},
            normalizers={k: {f: getattr(v, f).clone() for f in ("acc_count", "num_accumulations", "acc_sum",
                                                                  "acc_sum_squared")}
                         for k, v in tstate.model.normalizers.items()},
            grads=grads,
            params_drawn={n: p.detach().clone() for n, p in drawn.model.params.named_parameters()},
            grads_drawn={n: p.grad.clone() for n, p in drawn.model.params.named_parameters()},
            layout=(group.shape, group.data_size, group.processes, group.process),
            devices=[str(d) for d in group.devices],
            copies={str(d): {n: p.detach().clone() for n, p in m.named_parameters()} for d, m in step.copies.items()},
            rows=next(iter(batch.values())).shape[0],
            processes=(multihost.process_count(), multihost.process_index()),
            trajectories=list(multihost.host_trajectory_indices(10)),
        ), dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6:] == ["spread"])
