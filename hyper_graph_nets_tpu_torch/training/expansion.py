"""Graph expansion: the graph balancer, then remote message passing.

Counterpart of ``hyper_graph_nets_tpu/training/expansion.py``.  The members
run in the JAX package's order (balancer first, then RMP), each with its own
reset cadence; the composite's static is the tuple of the members' statics,
which a train step or a prediction takes in place of running ``prepare``
again.  The training noise on RMP's cluster means is a standard-normal draw
passed in (``hyper_normal``) or drawn from ``generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from hyper_graph_nets_tpu_torch.models.base import reset_due


def _freeze(obj):
    """Canonical hashable form of a (nested) config value."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


class CompositeExpansion:
    """Ordered expansions, each reset on its own cadence.  ``fingerprint``
    is a hashable key of the building config."""

    def __init__(self, members: Sequence, frequencies: Sequence[int], fingerprint=None):
        assert len(members) == len(frequencies)
        self.members = list(members)
        self.frequencies = list(frequencies)
        self.fingerprint = fingerprint or (
            tuple(type(m).__name__ for m in members),
            tuple(frequencies),
        )

    def reset(self, step: int, num_steps: int) -> None:
        """Drop each member's cache when its cadence says so."""
        for member, freq in zip(self.members, self.frequencies):
            if reset_due(step, num_steps, freq):
                if hasattr(member, "reset_clusters"):
                    member.reset_clusters()
                if hasattr(member, "reset_balancer"):
                    member.reset_balancer()

    def prepare(self, model, frame: Dict[str, np.ndarray], topo) -> Tuple:
        return tuple(m.prepare(model, frame, topo) for m in self.members)

    def hyper_noise_shape(self, model, frames, static: Optional[Tuple] = None) -> Optional[tuple]:
        """Shape ``[..., K, D]`` of RMP's training noise on the cluster means
        for ``frames`` (None without RMP noise)."""
        statics = static if static is not None else self.static
        for member, member_static in zip(self.members, statics):
            if getattr(getattr(member, "connector", None), "noise_scale", None) is None:
                continue
            target, mesh = model.geometry(frames)
            K = (member_static if member_static is not None else member.static).num_clusters
            return tuple(target.shape[:-2]) + (K, target.shape[-1] + mesh.shape[-1])
        return None

    @property
    def static(self) -> Tuple:
        """The members' current statics."""
        return tuple(m.static for m in self.members)

    def expand(
        self,
        state,
        graph,
        frames,
        model,
        is_training: bool,
        static: Optional[Tuple] = None,
        hyper_normal=None,
        generator=None,
    ):
        """Apply every member; returns ``(graph, state)``.  ``static`` (a
        tuple from :meth:`prepare`) replaces the members' cached statics;
        ``hyper_normal`` and ``generator`` go to RMP (its training noise)."""
        statics = static if static is not None else (None,) * len(self.members)
        for member, member_static in zip(self.members, statics):
            noise = {}
            if hasattr(member, "reset_clusters"):
                noise = dict(normal=hyper_normal, generator=generator)
            graph, state = member.expand(
                state, graph, frames, model, is_training=is_training, static=member_static, **noise
            )
        return graph, state


def build_expansion(model, config: dict) -> Optional[CompositeExpansion]:
    """The configured expansion (the graph balancer, then RMP), or None."""
    from hyper_graph_nets_tpu_torch.balancer.base import get_balancer
    from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import get_rmp

    members, freqs = [], []
    balancer = get_balancer(config)
    if balancer is not None:
        members.append(balancer)
        freqs.append(model.balance_frequency)
    rmp = get_rmp(config)
    if rmp is not None:
        members.append(rmp)
        freqs.append(model.rmp_frequency)
    if not members:
        return None
    model_cfg = config.get("params", config).get("model", config.get("model", {}))
    fingerprint = (
        _freeze(model_cfg.get("rmp", {})),
        _freeze(model_cfg.get("graph_balancer", {})),
        tuple(freqs),
    )
    return CompositeExpansion(members, freqs, fingerprint=fingerprint)
