"""MeshSimulator: training and evaluation of a mesh model.

Counterpart of ``hyper_graph_nets_tpu/training/simulator.py``:

- ``fit_trajectory``: the expansion's reset cadence and ``prepare`` run over
  the frame batches in temporal order, then the batch order is shuffled
  with ``np.random.RandomState(random_seed)``, and one ``Trainer.train_step``
  runs per batch.  The losses stay on the device until one sync at the end.
- ``one_step_evaluator`` (validation loss and de-normalized error),
  ``rollout_evaluator`` (rollouts and per-step MSE curves, pickled
  rollouts), ``n_step_evaluator`` (sliding windows, a chunk of windows per
  batch).
- with ``agg_vjp: fused``, meshes the JAX fused kernel's band criterion
  rejects are relabelled in reverse Cuthill-McKee order (``ops/reorder.py``),
  as the JAX simulator does, so both packages' rollouts match node for node.
- with a capacity (:meth:`MeshSimulator.set_capacity`, set by the task when
  the dataset's meshes differ in size), every trajectory is relabelled, then
  padded to the capacity, and its topology built at it
  (``data/bucketing.py``), as in the JAX package: the rollout and n-step
  losses are then means over the capacity's rows, as there.

The model counters of the steps (plate's ``world_edge_truncated``) are
summed per trajectory in training and per pass in the one-step evaluator, on
the device until the one sync at the end.

Runs on the card unless ``device="cpu"``.  The training noise is drawn by
:meth:`MeshSimulator._normal` from a seeded generator on the device: the
field's, then (with RMP's ``hyper_noise``) the cluster means'.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges, mesh_fingerprint
from hyper_graph_nets_tpu_torch.data import bucketing
from hyper_graph_nets_tpu_torch.models.base import Topology, reset_due
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.ops import reorder
from hyper_graph_nets_tpu_torch.training.trainer import TrainState, Trainer, frames_to_batches
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict
from hyper_graph_nets_tpu_torch.utils.metrics import MetricsLogger


class MeshSimulator:
    def __init__(self, config: dict, out_dir: Optional[str] = None, device=None):
        self.config = config
        params = config.get("params", config)
        self.params = params
        self.model = get_model(config)
        self.trainer = Trainer(self.model, config, device=device)
        self.device = self.trainer.device
        self.expansion = self.trainer.expansion
        self.batch_size = get_from_nested_dict(params, ["task", "batch_size"], default_return=1)
        self.time_steps = get_from_nested_dict(params, ["task", "n_timesteps"], default_return=None)
        self.out_dir = out_dir or "output"
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger: Optional[MetricsLogger] = None
        self._topo_cache: Dict[Tuple, Any] = {}
        seed = params.get("random_seed", 0)
        self._noise = torch.Generator(device=self.device).manual_seed(seed)
        # the batch-order shuffle within a trajectory, seeded as the JAX
        # simulator's (simulator.py:66)
        self._shuffle_rng = np.random.RandomState(seed)
        # the bucket's capacity, band decision and model dims (set_capacity)
        self.capacity: Optional[Tuple[int, int]] = None
        self._plan_dims = None
        self._topo_extras: Optional[dict] = None

    def set_capacity(self, num_nodes: int, num_edges: int, plan_dims=None,
                     topo_extras: Optional[dict] = None) -> None:
        """Pad every trajectory to ``num_nodes`` nodes and its topology to
        ``num_edges`` edges.  ``plan_dims`` is the bucket's band decision
        (``data.bucketing.bucket_plan_dims``) and ``topo_extras`` the
        model's bucket dims (``bucket_topology_extras``)."""
        self.capacity = (num_nodes, num_edges)
        self._plan_dims = plan_dims
        self._topo_extras = topo_extras

    def _prepare(self, trajectory: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The trajectory as the steps see it: relabelled, then padded to
        the capacity when one is set."""
        trajectory = self._maybe_reorder(trajectory)
        if self.capacity is None:
            return trajectory
        return bucketing.pad_trajectory(trajectory, self.capacity[0])

    def initialize(self, logger: Optional[MetricsLogger] = None) -> TrainState:
        """A fresh train state (weights from the config's random seed)."""
        self.logger = logger or MetricsLogger(self.out_dir, self.config)
        seed = self.params.get("random_seed", 0)
        return self.trainer.init_train_state(torch.Generator().manual_seed(seed))

    def _mesh_key(self, tag: str, trajectory: Dict[str, np.ndarray]) -> Tuple:
        """Cache key from the mesh content (connectivity only for "rcm")."""
        key = (tag,) + mesh_fingerprint(trajectory["cells"][0], trajectory["node_type"].shape[1])
        if tag != "rcm":
            key += self.model.topology_content_key(trajectory)
        return key

    def _maybe_reorder(self, trajectory: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Relabel the nodes in reverse Cuthill-McKee order when the JAX fused
        kernel's band criterion rejects the natural order (``agg_vjp:
        fused`` only), as the JAX simulator does: a pure renumbering, the
        permutation cached per mesh."""
        if self.model.params["model"].get("agg_vjp") != "fused":
            return trajectory
        key = self._mesh_key("rcm", trajectory)
        if key not in self._topo_cache:
            edges = cells_to_edges(np.asarray(trajectory["cells"][0]))
            n = int(trajectory["node_type"].shape[1])
            self._topo_cache[key] = (
                None
                if reorder.check_banded(edges.senders, edges.receivers)
                else reorder.rcm_order(edges.senders, edges.receivers, n)
            )
        perm = self._topo_cache[key]
        return trajectory if perm is None else reorder.reorder_trajectory(trajectory, perm)

    def _topology(self, trajectory: Dict[str, np.ndarray]) -> Topology:
        """The topology of a prepared trajectory (at the capacity when one
        is set), cached by mesh and model content."""
        key = self._mesh_key("topo", trajectory)
        if key not in self._topo_cache:
            if self.capacity is not None:
                self._topo_cache[key] = bucketing.pad_topology(
                    self.model, trajectory, *self.capacity, plan_dims=self._plan_dims,
                    topo_extras=self._topo_extras, device=self.device,
                )
            else:
                self._topo_cache[key] = self.model.topology_from_trajectory(trajectory, device=self.device)
        return self._topo_cache[key]

    def _prepare_expansion(self, trajectory, topo):
        """Reset the expansion and prepare it on the trajectory's first
        frame; returns its static, or None without an expansion."""
        if self.expansion is None:
            return None
        self.expansion.reset(0, trajectory["cells"].shape[0])
        frame0 = {k: v[0] for k, v in trajectory.items()}
        return self.expansion.prepare(self.model, frame0, topo)

    def _normal(self, shape) -> torch.Tensor:
        """A standard-normal draw for the training noise."""
        return torch.randn(shape, generator=self._noise, device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def fit_trajectory(
        self, tstate: TrainState, trajectory: Dict[str, np.ndarray], epoch: int = 0
    ) -> Tuple[TrainState, List[float]]:
        """Train over one trajectory in frame batches; returns the new state
        and the batches' losses in the order they ran.

        The batches are prepared in temporal order (the expansion's reset
        cadence is a function of the frame index), then their order is
        shuffled.  "training time per instance" is the host's time to issue
        a step, not the device's; the trajectory's wall time, taken after
        the one sync at the end, gives ``edges_per_s``.
        """
        trajectory = self._prepare(trajectory)
        topo = self._topology(trajectory)
        T = trajectory["cells"].shape[0]
        num_steps = min(T, self.time_steps or T)
        start_traj = time.time()

        jobs: List[Tuple[int, int, Any]] = []
        for start in range(0, num_steps, self.batch_size):
            end = min(start + self.batch_size, num_steps)
            static = None
            if self.expansion is not None:
                for i in range(start, end):
                    if any(reset_due(i, num_steps, f) for f in self.expansion.frequencies):
                        self.expansion.reset(i, num_steps)
                        break
                frame0 = {k: v[start] for k, v in trajectory.items()}
                static = self.expansion.prepare(self.model, frame0, topo)
            jobs.append((start, end, static))
        self._shuffle_rng.shuffle(jobs)

        device_losses: List[torch.Tensor] = []
        device_metrics: Dict[str, torch.Tensor] = {}
        dispatch_times: List[float] = []
        field = self.model.field
        for start, end, static in jobs:
            frames = self.trainer.frames({k: v[start:end] for k, v in trajectory.items()})
            normal = None if self.model.noise_scale is None else self._normal(frames[field].shape)
            hyper_normal = None
            if self.expansion is not None:
                shape = self.expansion.hyper_noise_shape(self.model, frames, static)
                hyper_normal = None if shape is None else self._normal(shape)
            t0 = time.time()
            tstate, loss, metrics = self.trainer.train_step(
                tstate, topo, frames, normal=normal, static=static, hyper_normal=hyper_normal,
                with_metrics=True,
            )
            device_losses.append(loss)
            for name, v in metrics.items():
                device_metrics[name] = device_metrics.get(name, 0) + v
            dispatch_times.append(time.time() - t0)

        losses = torch.stack(device_losses).tolist() if device_losses else []
        # per-trajectory sums of the steps' model counters
        metric_sums = {name: float(v) for name, v in device_metrics.items()}
        if self.logger:
            for loss, dt in zip(losses, dispatch_times):
                self.logger.log({"loss": loss, "training time per instance": dt})
            elapsed = time.time() - start_traj
            num_edges = int(topo.senders.shape[0])
            valid_edges = float(topo.mask.sum()) if topo.mask is not None else num_edges
            self.logger.log(
                {
                    "training time per trajectory": elapsed,
                    "loss per trajectory": float(np.mean(losses)) if losses else 0.0,
                    "edges_per_s": num_steps * num_edges / max(elapsed, 1e-9),
                    "edges_per_s_valid": num_steps * valid_edges / max(elapsed, 1e-9),
                    **metric_sums,
                },
                commit=False,
            )
        return tstate, losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def one_step_evaluator(
        self,
        tstate: TrainState,
        trajectories: Iterable[Dict[str, np.ndarray]],
        n_trajectories: Optional[int] = None,
        logging: bool = True,
    ) -> Dict[str, float]:
        """Validation loss and de-normalized error over frame batches."""
        device_out: List[torch.Tensor] = []
        device_metrics: Dict[str, torch.Tensor] = {}
        for idx, traj in enumerate(trajectories):
            if n_trajectories is not None and idx >= n_trajectories:
                break
            traj = self._prepare(traj)
            topo = self._topology(traj)
            static = self._prepare_expansion(traj, topo)
            for frames in frames_to_batches(traj, self.batch_size, self.time_steps, device=self.device):
                loss, err, metrics = self.trainer.validation_step(
                    tstate.model, topo, frames, static=static, with_metrics=True
                )
                device_out.append(torch.stack([loss, err]))
                for name, v in metrics.items():
                    device_metrics[name] = device_metrics.get(name, 0) + v
        pairs = torch.stack(device_out).tolist() if device_out else []
        losses = [p[0] for p in pairs]
        errors = [p[1] for p in pairs]
        result = {
            "validation_loss": float(np.mean(losses)) if losses else float("nan"),
            "position_error": float(np.mean(errors)) if errors else float("nan"),
            **{name: float(v) for name, v in device_metrics.items()},
        }
        if logging and self.logger:
            self.logger.log(result, commit=False)
            self.logger.log_histogram("validation_loss_hist", losses)
            self.logger.log_table(
                "one_step_eval",
                list(zip(range(len(losses)), losses, errors)),
                ["instance", "loss", "position_error"],
            )
        return result

    @torch.no_grad()
    def rollout_evaluator(
        self,
        tstate: TrainState,
        trajectories: Iterable[Dict[str, np.ndarray]],
        n_rollouts: Optional[int] = None,
        num_steps: Optional[int] = None,
        logging: bool = True,
        save: bool = True,
    ) -> Dict[str, Any]:
        """Recursive rollouts (batch 1) and their mean per-step MSE."""
        state = self.model.inference_state(tstate.model)
        all_mse: List[np.ndarray] = []
        rollouts: List[Dict[str, np.ndarray]] = []
        for idx, traj in enumerate(trajectories):
            if n_rollouts is not None and idx >= n_rollouts:
                break
            traj = self._prepare(traj)
            topo = self._topology(traj)
            freqs = self.expansion.frequencies if self.expansion else []
            if any(f > 1 for f in freqs):
                ops, mse = self._segmented_rollout(state, traj, topo, num_steps)
            else:
                static = self._prepare_expansion(traj, topo)
                ops, mse = self.model.rollout(
                    state, topo, traj, num_steps=num_steps, expansion=self.expansion, static=static
                )
            all_mse.append(mse.cpu().numpy())
            rollouts.append(
                {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in ops.items()}
            )
        mean_curve = np.mean(np.stack(all_mse), axis=0) if all_mse else np.zeros(0)
        eval_metrics = self.model.pop_eval_metrics()
        result = {
            "rollout_loss": float(mean_curve.mean()) if len(mean_curve) else float("nan"),
            "rollout_loss_last": float(mean_curve[-1]) if len(mean_curve) else float("nan"),
            "rollouts": rollouts,
            "mse_curve": mean_curve,
            **eval_metrics,
        }
        if save:
            self.save_rollouts(rollouts)
        if logging and self.logger:
            self.logger.log({"rollout_loss": result["rollout_loss"], **eval_metrics}, commit=False)
            self.logger.log_table("rollout_losses", list(enumerate(mean_curve.tolist())), ["step", "mse"])
        return result

    def _segmented_rollout(self, state, traj, topo, num_steps):
        """Rollout for an expansion that resets mid-rollout (frequency > 1):
        it runs in segments between reset frames, and each segment prepares
        the expansion on the predicted state carried over."""
        T = traj["cells"].shape[0]
        T = T if num_steps is None else min(num_steps, T)
        boundaries = sorted(
            {i for f in self.expansion.frequencies for i in range(T) if reset_due(i, T, f)}
        ) or [0]
        preds, mses = [], []
        carry = None
        ops = None
        for bi, s0 in enumerate(boundaries):
            s1 = boundaries[bi + 1] if bi + 1 < len(boundaries) else T
            sub = {k: v[s0:s1] for k, v in traj.items()}
            frame0 = {k: np.asarray(v[0]) for k, v in sub.items()}
            if carry is not None:
                frame0.update({k: v.cpu().numpy() for k, v in self.model.carry_to_frame(carry).items()})
            self.expansion.reset(s0, T)
            static = self.expansion.prepare(self.model, frame0, topo)
            ops, mse, carry = self.model.rollout(
                state, topo, sub, num_steps=s1 - s0, expansion=self.expansion,
                static=static, start_carry=carry, return_carry=True,
            )
            pred_key = "pred_pos" if "pred_pos" in ops else "pred_velocity"
            preds.append(ops[pred_key])
            mses.append(mse)
        ops = dict(ops)
        ops[pred_key] = torch.cat(preds)
        ops["mesh_pos"] = traj["mesh_pos"]
        ops["faces"] = traj["cells"]
        gt_key = "gt_pos" if pred_key == "pred_pos" else "gt_velocity"
        ops[gt_key] = traj["world_pos" if gt_key == "gt_pos" else "velocity"][:T]
        return ops, torch.cat(mses)

    @torch.no_grad()
    def n_step_evaluator(
        self,
        tstate: TrainState,
        trajectories: Iterable[Dict[str, np.ndarray]],
        n_step: int = 60,
        n_trajectories: Optional[int] = None,
        num_timesteps: Optional[int] = None,
        logging: bool = True,
    ) -> Dict[str, float]:
        """Sliding n-step losses (mean over windows, and of the last step)."""
        state = self.model.inference_state(tstate.model)
        means: List[float] = []
        lasts: List[float] = []
        for idx, traj in enumerate(trajectories):
            if n_trajectories is not None and idx >= n_trajectories:
                break
            traj = self._prepare(traj)
            topo = self._topology(traj)
            static = self._prepare_expansion(traj, topo)
            T = traj["cells"].shape[0]
            nt = min(num_timesteps or T, T)
            n = min(n_step, nt - 1)
            mean, last = self.model.n_step_computation(
                state, topo, traj, n_step=n, num_timesteps=nt, expansion=self.expansion, static=static
            )
            means.append(mean)
            lasts.append(last)
        result = {
            "n_step_loss": float(np.mean(means)) if means else float("nan"),
            "n_step_last_loss": float(np.mean(lasts)) if lasts else float("nan"),
            **self.model.pop_eval_metrics(),
        }
        if logging and self.logger:
            self.logger.log(result, commit=False)
        return result

    # ------------------------------------------------------------------
    def save_rollouts(self, rollouts: List[Dict[str, np.ndarray]]) -> str:
        """Pickle the rollouts (numpy arrays) to ``rollouts.pkl`` and record
        them in the artifact manifest."""
        path = os.path.join(self.out_dir, "rollouts.pkl")
        with open(path, "wb") as f:
            pickle.dump(rollouts, f)
        if self.logger:
            self.logger.log_artifact("rollouts", path, kind="dataset")
        return path

    def visualize_clusters(self, out_path: str):
        """The current cluster assignment of each RMP member: a PNG at
        ``out_path`` when matplotlib imports (its path is returned, and
        logged as an artifact), else the first member's labels; None when no
        member has clustered yet."""
        if self.expansion is None:
            return None
        first = None
        for member in self.expansion.members:
            coords = getattr(member, "last_coordinates", None)
            if not hasattr(member, "visualize_cluster") or coords is None:
                continue
            out = member.visualize_cluster(coords, out_path=out_path)
            if isinstance(out, str) and self.logger:
                self.logger.log_artifact("cluster_viz", out, kind="image")
            first = out if first is None else first
        return first
