"""Graph expansion (graph balancer, remote message passing).

Counterpart of ``build_expansion`` in
``hyper_graph_nets_tpu/training/expansion.py``.  Neither the balancer nor
RMP is ported yet, so a config that asks for either raises: the port never
serves a flat graph in place of the configured hierarchy.
"""
from __future__ import annotations


def build_expansion(model, config: dict):
    """The configured expansion: None when neither RMP nor the balancer is set."""
    if model.use_balancer:
        raise NotImplementedError(
            "graph_balancer: the balancer (kernel K5) comes in ROADMAP slice 4"
        )
    if model.use_rmp:
        raise NotImplementedError(
            "rmp: remote message passing and the hierarchical blocks come in "
            "ROADMAP slice 8; set model.rmp.clustering and model.rmp.connector "
            "to 'none' to serve the flat MeshGraphNets model"
        )
    return None
