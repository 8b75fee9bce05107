"""Command line: ``python -m hyper_graph_nets_tpu_torch.main <config>``.

Counterpart of the repository's ``main.py``: seeds the RNGs, reads
``configs/<config>.yaml``, builds the task, runs its epochs and prints the
final evaluation scalars, one ``name: value`` line each.  Runs on the card
unless ``--cpu`` (and raises without one).  Exits 1 when there are no
scalars or one is not finite.

    python -m hyper_graph_nets_tpu_torch.main flag_fused_demo [--data-dir D] [--cpu]
"""
from __future__ import annotations

import argparse
import random
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="HyperGraphNets on PyTorch")
    parser.add_argument("config", help="config name under configs/ (e.g. flag_fused_demo)")
    parser.add_argument("--data-dir", default=None, help="override the data directory")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    import torch

    from hyper_graph_nets_tpu_torch.training.task import get_task
    from hyper_graph_nets_tpu_torch.utils.config import read_yaml

    config = read_yaml(args.config)
    seed = config.get("params", config).get("random_seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    task = get_task(config, data_dir=args.data_dir, device="cpu" if args.cpu else None)
    task.run_iterations()
    scalars = task.get_scalars()
    for key, value in scalars.items():
        print(f"{key}: {value}")
    bad = [k for k, v in scalars.items() if isinstance(v, (int, float, np.floating)) and not np.isfinite(v)]
    if not scalars or bad:
        what = "no scalars" if not scalars else "non-finite scalars: " + ", ".join(bad)
        print(f"ERROR: run produced {what}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
