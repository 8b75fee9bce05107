"""Model factory: the dataset name picks flag, cylinder or plate."""
from __future__ import annotations

from hyper_graph_nets_tpu_torch.models.base import SystemModel
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict


def get_model(config: dict) -> SystemModel:
    params = config.get("params", config)
    dataset = get_from_nested_dict(params, ["task", "dataset"], raise_error=True)
    if "flag" in dataset:
        from hyper_graph_nets_tpu_torch.models.flag import FlagModel

        return FlagModel(params)
    if "cylinder" in dataset:
        from hyper_graph_nets_tpu_torch.models.cylinder import CylinderModel

        return CylinderModel(params)
    if "plate" in dataset:
        from hyper_graph_nets_tpu_torch.models.plate import PlateModel

        return PlateModel(params)
    raise NotImplementedError(f"unknown dataset {dataset!r}")
