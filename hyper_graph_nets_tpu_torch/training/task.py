"""MeshTask: the experiment loop.

Counterpart of ``hyper_graph_nets_tpu/training/task.py``: per epoch, fit
every training trajectory, then the one-step, rollout and n-step evaluators
on the validation split, the rollout GIF and a checkpoint; resume from the
newest checkpoint (the port's or the JAX package's) unless ``retrain``;
``get_scalars`` evaluates the test split.  When the meshes of the dataset
differ in size, every trajectory is padded to one capacity
(:meth:`MeshTask._setup_bucketing`, ``data/bucketing.py``), as in the JAX
package.

Example::

    from hyper_graph_nets_tpu_torch.training.task import get_task
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml
    task = get_task(read_yaml("flag_fused_demo"), data_dir="/tmp/run")  # on the card
    task.run_iterations()
    print(task.get_scalars())
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from hyper_graph_nets_tpu_torch.data import bucketing
from hyper_graph_nets_tpu_torch.data.loader import get_data, get_directories
from hyper_graph_nets_tpu_torch.training import checkpoint
from hyper_graph_nets_tpu_torch.training.get_algorithm import get_algorithm
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict
from hyper_graph_nets_tpu_torch.utils.metrics import MetricsLogger
from hyper_graph_nets_tpu_torch.utils.viz import animate_rollout


class AbstractTask:
    def __init__(self, config: dict):
        self.config = config

    def run_iterations(self):
        raise NotImplementedError

    def get_scalars(self) -> Dict[str, float]:
        raise NotImplementedError


class MeshTask(AbstractTask):
    def __init__(self, config: dict, data_dir: Optional[str] = None, device=None):
        super().__init__(config)
        params = config.get("params", config)
        self.params = params
        task = params["task"]
        self.dataset = task["dataset"]
        self.epochs = task.get("epochs", 1)
        self.trajectories = task.get("trajectories", 1)
        self.n_timesteps = task.get("n_timesteps")
        self.test_cfg = task.get("test", {})
        self.valid_cfg = task.get("validation", {})
        _, out_dir = get_directories(self.dataset, data_dir)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._data_dir = data_dir

        self.simulator = get_algorithm(config, out_dir=out_dir, device=device)
        self.logger = MetricsLogger(out_dir, config)
        self.tstate = self.simulator.initialize(self.logger)
        self.start_epoch = 0
        self._setup_bucketing()
        if not params.get("retrain", False):
            found = checkpoint.latest(out_dir, config)
            if found is not None:
                path, _ = found
                self.tstate, self.start_epoch, _ = checkpoint.load(path, self.simulator.trainer)
                self.logger.log({"resumed_from_epoch": self.start_epoch}, commit=False)

    def _setup_bucketing(self) -> None:
        """Pad every trajectory to one capacity when the meshes differ in
        size, as the JAX package's task does (``training/task.py:70-161``).

        The splits are scanned once, each up to its configured trajectory
        count, and the result is cached as ``capacity.json`` beside the
        dataset, with the JAX package's keys (``variable``, ``max_nodes``,
        ``max_edges``): each package reads the file the other wrote.  With
        sizes that vary, the relabelled scan gives the bucket's band
        decision (``bucketing.bucket_plan_dims``) and the model's bucket
        dims (``bucket_topology_extras``)."""
        in_dir, _ = get_directories(self.dataset, self._data_dir)
        cache = os.path.join(in_dir, "capacity.json")
        limits = {
            "train": self.trajectories,
            "valid": max(self.valid_cfg.get("trajectories", 1), self.valid_cfg.get("rollouts", 1)),
            "test": max(self.test_cfg.get("trajectories", 1), self.test_cfg.get("rollouts", 1)),
        }

        def scan():
            for split, limit in limits.items():
                for i, traj in enumerate(self._data(split)):
                    if i >= limit:
                        break
                    yield traj

        if os.path.exists(cache):
            with open(cache) as f:
                info = json.load(f)
        else:
            trajs = list(scan())
            max_nodes, max_edges = bucketing.trajectory_capacity(trajs)
            info = {
                "variable": len({t["node_type"].shape[1] for t in trajs}) > 1,
                "max_nodes": max_nodes,
                "max_edges": max_edges,
            }
            try:
                with open(cache, "w") as f:
                    json.dump(info, f)
            except OSError:
                pass
        if not info.get("variable"):
            return
        model = self.simulator.model
        scanned = [self.simulator._maybe_reorder(t) for t in scan()]
        self.simulator.set_capacity(
            info["max_nodes"], info["max_edges"],
            plan_dims=bucketing.bucket_plan_dims(model, scanned, info["max_nodes"], info["max_edges"]),
            topo_extras=model.bucket_topology_extras(scanned),
        )

    def _data(self, split: str):
        return get_data(self.config, split, data_dir=self._data_dir)

    def run_iterations(self) -> None:
        """The epochs from ``start_epoch`` on."""
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            for idx, traj in enumerate(self._data("train")):
                if idx >= self.trajectories:
                    break
                self.tstate, _ = self.simulator.fit_trajectory(self.tstate, traj, epoch=epoch)
            self.simulator.one_step_evaluator(
                self.tstate, self._data("valid"),
                n_trajectories=self.valid_cfg.get("trajectories", 1),
            )
            rollout = self.simulator.rollout_evaluator(
                self.tstate, self._data("valid"),
                n_rollouts=self.valid_cfg.get("rollouts", 1),
                num_steps=self.n_timesteps,
            )
            self.simulator.n_step_evaluator(
                self.tstate, self._data("valid"),
                n_step=self.test_cfg.get("n_steps", 60),
                n_trajectories=self.test_cfg.get("n_step_rollouts", 1),
                num_timesteps=self.n_timesteps,
            )
            self.select_plotting(rollout, epoch)
            self.simulator.visualize_clusters(os.path.join(self.out_dir, f"cluster_epoch{epoch}.png"))
            checkpoint.save(self.out_dir, self.config, self.tstate, epoch + 1)
            self.logger.log({"epoch": epoch, "epoch_time": time.time() - t0})

    def select_plotting(self, rollout_result: Dict, epoch: int) -> Optional[str]:
        """GIFs of up to ``validation.n_viz`` rollouts; the first path, or
        None when none was written."""
        rollouts = rollout_result.get("rollouts", [])
        n_viz = self.valid_cfg.get("n_viz", 1)
        first = None
        for i, ops in enumerate(rollouts[: max(1, n_viz)]):
            suffix = f"_{i}" if i else ""
            path = os.path.join(self.out_dir, f"rollout_epoch{epoch}{suffix}.gif")
            key = "pred_pos" if "pred_pos" in ops else "pred_velocity"
            out = animate_rollout(
                ops, self.simulator.model.model_type, path, stride=max(1, len(ops[key]) // 20)
            )
            if out:
                self.logger.log_artifact(f"rollout_gif_epoch{epoch}", out, kind="image")
            first = first or out
        return first

    def get_scalars(self) -> Dict[str, float]:
        """The test split's one-step loss and error, rollout loss and n-step
        loss (plate: and ``test_world_edge_truncated``)."""
        one_step = self.simulator.one_step_evaluator(
            self.tstate, self._data("test"),
            n_trajectories=self.test_cfg.get("trajectories", 1), logging=False,
        )
        rollout = self.simulator.rollout_evaluator(
            self.tstate, self._data("test"),
            n_rollouts=self.test_cfg.get("rollouts", 1), num_steps=self.n_timesteps,
            logging=False, save=False,
        )
        n_step = self.simulator.n_step_evaluator(
            self.tstate, self._data("test"),
            n_step=self.test_cfg.get("n_steps", 60),
            n_trajectories=self.test_cfg.get("n_step_rollouts", 1),
            num_timesteps=self.n_timesteps, logging=False,
        )
        scalars = {
            "test_loss": one_step["validation_loss"],
            "test_position_error": one_step["position_error"],
            "test_rollout_loss": rollout["rollout_loss"],
            "test_n_step_loss": n_step["n_step_loss"],
        }
        # plate: the radius-query hits the world-edge capacity dropped over
        # the three evaluations (nonzero: a capped query lost contact)
        results = (one_step, rollout, n_step)
        if any("world_edge_truncated" in r for r in results):
            scalars["test_world_edge_truncated"] = float(sum(r.get("world_edge_truncated", 0) for r in results))
        return scalars


def get_task(config: dict, data_dir: Optional[str] = None, device=None) -> AbstractTask:
    """'mesh' -> MeshTask (on the card unless ``device="cpu"``)."""
    params = config.get("params", config)
    name = get_from_nested_dict(params, ["task", "task"], default_return="mesh")
    if name == "mesh":
        return MeshTask(config, data_dir=data_dir, device=device)
    raise NotImplementedError(f"unknown task {name!r}")
