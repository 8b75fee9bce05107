"""K1 (bf16) at its main-path shapes and K5 at 1,600^3, traced device
time on the card, for the checkout the command runs in.

Run from the root of a checkout (it imports that checkout's
``chip_smoke.py`` and port), on an H100, with a tag for the output lines;
to compare two commits, unpack both and run them in turns in one call
(parent, change, change, parent):

    python tools/torch_port/kernel_times.py change [--halo] [--e2 DIR]
    (cd parent_checkout && python ../tools/torch_port/kernel_times.py parent [--halo] [--e2 DIR])

Shapes: the 40x40 flag at B=21 (one_step, training) and B=1 (rollout);
K1's raw mode on rank 0's shard of the halo forward, both layouts: 2,560
edges padded and dealt round-robin by 256-edge chunks (overlap), 2,321
contiguous edges (fused); K5 on a random 1,600^3 product.  With
``--halo`` also the checkout's own K6 and K7 checks and timings
(``chip_smoke.phase_ring`` and ``phase_overlap``), whose per-launch times
include the spins of ranks that wait for their neighbours.

With ``--e2 DIR`` K1's outputs at every shape (the same seeded inputs in
every checkout) are saved to ``DIR/TAG.pt`` and held against each other
tag's file already in DIR: e2 must be equal bit for bit (exit 1 if not),
and whether the aggregates are equal too is printed.
"""
import argparse
import glob
import os
import sys


def k1_runs(cs, fb, torch, snd, rcv, N):
    """K1's launches at its shapes, on inputs made from seed 0."""
    gen = torch.Generator().manual_seed(0)
    per = -(-len(snd) // 4)
    runs = {}
    for B in (21, 1):
        x = cs.k1_inputs(torch.bfloat16, B, snd, rcv, N, 128, gen, "cuda")
        plan = fb.plan_segments(rcv, N, senders=snd).to("cuda")
        runs[f"B={B}"] = lambda x=x, plan=plan: fb.fused_edge_block(**x, plan=plan)
    shard = cs.overlap_shards(torch.bfloat16, gen)[0][0]
    a = (shard["e"][None], shard["sp"][None], shard["rp"][None], shard["weights"], shard["senders"],
         shard["receivers"], shard["mask"], N)
    runs["raw shard"] = lambda: fb.fused_edge_block_fwd(*a, plan=shard["plan"], raw=True)
    x1 = cs.k1_inputs(torch.bfloat16, 1, snd[:per], rcv[:per], N, 128, gen, "cuda")
    cp = fb.plan_segments(rcv[:per], N, senders=snd[:per]).to("cuda")
    a1 = (x1["e"], x1["sp"], x1["rp"], x1["weights"], x1["senders"], x1["receivers"], None, N)
    runs["raw contiguous shard"] = lambda: fb.fused_edge_block_fwd(*a1, plan=cp, raw=True)
    return runs


def hold_e2(torch, tag, outs, e2_dir):
    """Save this checkout's K1 outputs and hold them against the others'."""
    os.makedirs(e2_dir, exist_ok=True)
    torch.save(outs, os.path.join(e2_dir, f"{tag}.pt"))
    ok = True
    for path in sorted(glob.glob(os.path.join(e2_dir, "*.pt"))):
        other = os.path.basename(path)[:-3]
        if other == tag:
            continue
        theirs = torch.load(path)
        for shape, (e2, agg) in outs.items():
            same_e2 = torch.equal(e2, theirs[shape][0])
            same_agg = torch.equal(agg, theirs[shape][1])
            ok &= same_e2
            print(f"[{tag}] K1 {shape} against {other}: e2 bit for bit {same_e2}, "
                  f"aggregate bit for bit {same_agg}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--halo", action="store_true")
    ap.add_argument("--e2", metavar="DIR")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from hyper_graph_nets_tpu_torch.ops import fused_block as fb
    from hyper_graph_nets_tpu_torch.ops.maxprod import maxprod
    from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
    from hyper_graph_nets_tpu_torch.data.synthetic import _grid_triangulation
    from hyper_graph_nets_tpu_torch.runtime import configure_numerics

    configure_numerics()
    edges = cells_to_edges(_grid_triangulation(40, 40))
    runs = k1_runs(cs, fb, torch, edges.senders, edges.receivers, 1600)
    g5 = torch.Generator().manual_seed(3)
    rnd = lambda *s: (torch.rand(*s, generator=g5) * (torch.rand(*s, generator=g5) > 0.5)).cuda()
    xa, ya = rnd(1600, 1600), rnd(1600, 1600)
    ok = True
    if args.e2:
        outs = {}
        for k, run in runs.items():
            e2, agg = run()
            outs[k] = (e2.cpu(), agg.cpu())
        ok = hold_e2(torch, args.tag, outs, os.path.abspath(args.e2))
    for _ in range(2):
        for k, run in runs.items():
            run(); torch.cuda.synchronize()
            ms = cs.kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
            print(f"[{args.tag}] K1 {k}: {ms * 1e3:.1f} us traced", flush=True)
        ms = cs.kernel_device_ms(lambda: maxprod(xa, ya), iters=20, names="maxprod_kernel")
        print(f"[{args.tag}] K5 random 1600^3: {ms * 1e3:.1f} us traced", flush=True)
    if args.halo:
        card, peaks = cs.nvidia_smi(), cs.peaks_for(torch.cuda.get_device_name(0))
        cs.log = lambda msg: print(f"[{args.tag}] {msg}", flush=True)
        cs.phase_ring(card, peaks, 0)
        cs.phase_overlap(card, peaks, 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
