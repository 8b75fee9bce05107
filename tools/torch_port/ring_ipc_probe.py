"""K6 across two processes that share one card: may a pod's ring run there?

A pod whose ``graph`` row spans processes rings K6 and K7 over CUDA IPC
(``parallel.group.RankGroup.ring_state``).  Two processes on one card
without MPS are time-sliced, and a ring kernel spins on its neighbour in
the other process, so this starts two processes (``gloo`` over 127.0.0.1),
each one rank of a 1 x 2 pod on the given card
(``make_pod_group(graph_per_host=2, devices=["cuda:<card>"])``), and calls
K6 on [ROWS, COLS] float32 partials ``--reps`` times.  Each call starts
from a barrier; it is timed on the host clock up to the end of
``group.check()`` and held bit for bit against the plain fold on the card.
A call that ends in the ring's spin error stops the process (the trap ends
its card context).  Prints one JSON line per process, then a summary line
and the card's name and power limit.

    python tools/torch_port/ring_ipc_probe.py [--reps 20] [--cards 0 0]

``--cards 0 1`` puts the processes on two cards (a ring across processes
and cards).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROWS, COLS = 64, 128
TIMEOUT_S = 120


def worker(rank: int, world: int, port: int, card: int, reps: int) -> dict:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments, ring_all_reduce_segments_reference
    from hyper_graph_nets_tpu_torch.parallel import multihost

    torch.cuda.set_device(card)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda", card)
    group = multihost.make_pod_group(graph_per_host=world, devices=[dev])
    q = group.ranks[0]
    segments = [(0, ROWS, "sum")]
    gen = torch.Generator().manual_seed(7)
    calls = []
    try:
        for i in range(reps):
            xs = [torch.randn(ROWS, COLS, generator=gen).to(dev) for _ in range(world)]
            want = ring_all_reduce_segments_reference(xs, segments)[q]
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            try:
                got = ring_all_reduce_segments([xs[q]], segments, group)[0]
                group.check()
            except RuntimeError as exc:
                calls.append(dict(call=i, error=str(exc)[:400]))
                break
            calls.append(dict(call=i, ms=1e3 * (time.perf_counter() - t0), bit_for_bit=bool(torch.equal(got, want))))
    finally:
        dist.destroy_process_group()
    return dict(process=rank, rank=q, card=card, calls=calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cards", type=int, nargs=2, default=[0, 0])
    ap.add_argument("--worker", type=int, nargs=3, metavar=("RANK", "PORT", "CARD"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, port, card = args.worker
        print(json.dumps(worker(rank, 2, port, card, args.reps)), flush=True)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--reps", str(args.reps), "--worker",
                               str(r), str(port), str(card)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r, card in enumerate(args.cards)]
    results, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                failed.append(dict(process=r, returncode=p.returncode, stderr=err[-2000:]))
                continue
            print(lines[-1], flush=True)
            results.append(json.loads(lines[-1]))
    except subprocess.TimeoutExpired:
        failed.append(dict(timeout_s=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    calls = [c for res in results for c in res["calls"]]
    ok = (not failed and len(results) == 2 and all(len(res["calls"]) == args.reps for res in results)
          and all(c.get("bit_for_bit") for c in calls))
    print(json.dumps({"probe": "k6_across_processes", "cards": args.cards, "payload": [ROWS, COLS],
                      "reps": args.reps, "completed": sum("ms" in c for c in calls),
                      "bit_for_bit": all(c.get("bit_for_bit") for c in calls) and bool(calls),
                      "errors": [c["error"] for c in calls if "error" in c] + failed,
                      "ms_by_process": [[c["ms"] for c in res["calls"] if "ms" in c] for res in results],
                      "ok": ok}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi: none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
