"""Model factory: flag only in this slice of the port."""
from __future__ import annotations

from hyper_graph_nets_tpu_torch.models.base import SystemModel
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict


def get_model(config: dict) -> SystemModel:
    params = config.get("params", config)
    dataset = get_from_nested_dict(params, ["task", "dataset"], raise_error=True)
    if "flag" in dataset:
        from hyper_graph_nets_tpu_torch.models.flag import FlagModel

        return FlagModel(params)
    if "cylinder" in dataset or "plate" in dataset:
        raise NotImplementedError(
            f"dataset {dataset!r}: plate and cylinder come in ROADMAP slice 7"
        )
    raise NotImplementedError(f"unknown dataset {dataset!r}")
