"""Does NCCL take two ranks of one process group on one card?

``parallel/multihost.py``'s port would run one process per rank with NCCL
for its all-reduces.  This starts two processes, both on ``cuda:0``, joins
them in one NCCL group over ``tcp://localhost`` and all-reduces a tensor;
it prints what each rank got (or the error NCCL raised) as one JSON line
per rank and the card's name and power limit.  Each process has a time
limit; a rank that hangs is reported as such and killed.

    python tools/torch_port/nccl_one_card.py [--timeout 120]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import subprocess
import sys


def rank_main(rank: int, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out.put({"rank": rank, "ok": True, "all_reduce": x.tolist(), "nccl": list(torch.cuda.nccl.version())})
        dist.destroy_process_group()
    except Exception as exc:  # reported, not hidden: the answer is the error
        out.put({"rank": rank, "ok": False, "error": f"{type(exc).__name__}: {str(exc)[:400]}"})
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(args.timeout)
    seen = []
    while not out.empty():
        seen.append(out.get())
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            seen.append({"rank": r, "ok": False, "error": f"no answer within {args.timeout} s (killed)"})
    for row in sorted(seen, key=lambda row: row["rank"]):
        print(json.dumps(row))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
