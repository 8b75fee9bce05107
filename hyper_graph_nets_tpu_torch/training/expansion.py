"""Graph expansion: the graph balancer (and, in a later slice, RMP).

Counterpart of ``hyper_graph_nets_tpu/training/expansion.py``.  The members
run in order, each with its own reset cadence; the composite's static is the
tuple of the members' statics, which a train step or a prediction takes in
place of running ``prepare`` again.  Remote message passing is not ported
yet, so a config that asks for it raises: the port never serves a flat graph
in place of the configured hierarchy.
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
                member.reset_balancer()

    def prepare(self, model, frame: Dict[str, np.ndarray], topo) -> Tuple:
        return tuple(m.prepare(model, frame, topo) for m in self.members)

    @property
    def static(self) -> Tuple:
        """The members' current statics."""
        return tuple(m.static for m in self.members)

    def expand(self, state, graph, frames, model, is_training: bool, static: Optional[Tuple] = None):
        """Apply every member; returns ``(graph, state)``.  ``static`` (a
        tuple from :meth:`prepare`) replaces the members' cached statics."""
        statics = static if static is not None else (None,) * len(self.members)
        for member, member_static in zip(self.members, statics):
            graph, state = member.expand(
                state, graph, frames, model, is_training=is_training, static=member_static
            )
        return graph, state


def build_expansion(model, config: dict) -> Optional[CompositeExpansion]:
    """The configured expansion: the graph balancer, or None.  RMP raises
    (ROADMAP slice 8)."""
    from hyper_graph_nets_tpu_torch.balancer.base import get_balancer

    if model.use_rmp:
        raise NotImplementedError(
            "rmp: remote message passing and the hierarchical blocks come in "
            "ROADMAP slice 8; set model.rmp.clustering and model.rmp.connector "
            "to 'none' to serve the flat MeshGraphNets model"
        )
    balancer = get_balancer(config)
    if balancer is None:
        return None
    model_cfg = config.get("params", config).get("model", config.get("model", {}))
    freqs = [model.balance_frequency]
    fingerprint = (
        _freeze(model_cfg.get("rmp", {})),
        _freeze(model_cfg.get("graph_balancer", {})),
        tuple(freqs),
    )
    return CompositeExpansion([balancer], freqs, fingerprint=fingerprint)
