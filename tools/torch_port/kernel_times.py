"""K1, K2, K3 (bf16) at their main-path shapes and K5 at 1,600^3, traced
device time on the card, for the checkout the command runs in.

Run from the root of a checkout (it imports that checkout's
``chip_smoke.py`` and port), on an H100, with a tag for the output lines;
to compare two commits, unpack both and run them in turns in one call
(parent, change, change, parent):

    python tools/torch_port/kernel_times.py change [--halo] [--e2 DIR] [--grads DIR] [--phases]
        [--ring-phases] [--halo-out DIR] [--f32]
    (cd parent_checkout && python ../tools/torch_port/kernel_times.py parent [--e2 DIR] [--grads DIR])

Shapes: the 40x40 flag at B=21 (one_step, training) and B=1 (rollout);
K1's raw mode on rank 0's shard of the halo forward, both layouts: 2,560
edges padded and dealt round-robin by 256-edge chunks (overlap), 2,321
contiguous edges (fused); K2 and K3 at B=21 on K1's own forward, each
timed as its three kernels together, and as each of them alone (the main
kernel, the sender sums, the column-sum reduction); K5 on a random 1,600^3
product.  With ``--halo`` also the checkout's own K6 and K7 checks and
timings (``chip_smoke.phase_ring`` and ``phase_overlap``): per call of all
ranks ungated (CUDA events, what a caller pays, the host's launch path
included) and gated (every rank's stream held behind one event until all
calls are queued: the kernels' own pace), and per rank's launch (traced,
the spins of ranks that wait for their neighbours included).

With ``--ring-phases`` K6 (2, 3 and 4 ranks) and K7 (bf16) also run from
the ring's phase-probe build (``-DHGN_RING_PHASES``, a library of its own),
ungated and gated: each phase's share of the ring CTAs' cycles, the cycles
per ring CTA and call, and K7's compute cycles per group.

With ``--halo-out DIR`` K6's outputs (2, 3 and 4 ranks with the pna
segments, and the odd ``[1004, 37]`` shape at 3 ranks) and K7's e2 and agg
(bf16 and float32), on the same seeded inputs in every checkout, are saved
to ``DIR/TAG-halo.pt`` and held against each other tag's file: all equal
bit for bit (exit 1 if not).

With ``--e2 DIR`` K1's outputs at every shape (the same seeded inputs in
every checkout) are saved to ``DIR/TAG.pt`` and held against each other
tag's file already in DIR: e2 must be equal bit for bit (exit 1 if not),
and whether the aggregates are equal too is printed.

With ``--grads DIR`` K2's and K3's outputs on the same seeded inputs in
every checkout (B=21 bf16, B=3 float32, and at B=3 bf16 a masked tail with
an isolated receiver, masks inside segments, and exactly tied edges) are
saved to ``DIR/TAG-grads.pt`` and held against each other tag's file: K2's
a1/a2 and de, dh, dz2, dz3 must be equal bit for bit (the forward keeps
K1's per-element chain, and the backward products keep theirs: mma.sync in
bf16, ordered fmaf in float32); dsp and drp within rtol 1e-5 and dpar
within relative L2 1e-4 per row (float32 sums in another order; whether
they are equal is printed).  Exit 1 if any check fails.

With ``--f32`` float32 K1 and K2 at the float32 families' shapes: cylinder
and plate at B=16 (one_step, training) and B=1 (rollout), HGN plate's mesh,
up and down sets at B=16 (their valid-prefix plans), and the 2 x 2 sharded
step's shard of cylinder and plate at B=8 (K1 raw, K2 at the global degree)
and cylinder's 1 x 4 overlap shard (K2); K3 at cylinder B=16.  Each is
checked against its plain version (and float64, where the checkout's
chip_smoke has ``hold_to_f64``) and timed (traced device time) beside its
bounds and the plain version's time.  With ``--phases`` also K1's and K2's
float32 phase shares at cylinder B=16 (``-DHGN_FWD_PHASES``,
``-DHGN_BWD_PHASES``; K1's only where the checkout's source has the probe).

With ``--phases`` K2 and K3 also run from the phase-probe build of the
backward source (``-DHGN_BWD_PHASES``, a library of its own): each phase's
share of a tile's cycles, summed over every team of every CTA, and the
cycles per tile.  The probe adds its clock reads (and, where a phase has
no barrier of its own, a barrier), so its kernel time is printed beside it
and is not the main path's.
"""
import argparse
import ctypes
import glob
import os
import sys

L = 128
BWD_PHASES = ("HGN_BWD_PHASES",)  # the define of the backward kernels' phase probe
FWD_PHASES = ("HGN_FWD_PHASES",)  # K1's


def k1_runs(cs, fb, torch, snd, rcv, N):
    """K1's launches at its shapes, on inputs made from seed 0."""
    gen = torch.Generator().manual_seed(0)
    per = -(-len(snd) // 4)
    runs = {}
    for B in (21, 1):
        x = cs.k1_inputs(torch.bfloat16, B, snd, rcv, N, L, gen, "cuda")
        plan = fb.plan_segments(rcv, N, senders=snd).to("cuda")
        runs[f"B={B}"] = lambda x=x, plan=plan: fb.fused_edge_block(**x, plan=plan)
    shard = cs.overlap_shards(torch.bfloat16, gen)[0][0]
    a = (shard["e"][None], shard["sp"][None], shard["rp"][None], shard["weights"], shard["senders"],
         shard["receivers"], shard["mask"], N)
    runs["raw shard"] = lambda: fb.fused_edge_block_fwd(*a, plan=shard["plan"], raw=True)
    x1 = cs.k1_inputs(torch.bfloat16, 1, snd[:per], rcv[:per], N, L, gen, "cuda")
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
        if other == tag or other.endswith("-grads"):
            continue
        theirs = torch.load(path)
        for shape, (e2, agg) in outs.items():
            same_e2 = torch.equal(e2, theirs[shape][0])
            same_agg = torch.equal(agg, theirs[shape][1])
            ok &= same_e2
            print(f"[{tag}] K1 {shape} against {other}: e2 bit for bit {same_e2}, "
                  f"aggregate bit for bit {same_agg}", flush=True)
    return ok


def bwd_case(cs, fb, torch, snd, rcv, N, dtype, B, seed, mask=None, rows=None):
    """K2 and K3 on K1's forward of seeded inputs: ``{"K2": run, "K3":
    run}``, each ``run(lib=None)`` one launch (``lib``: another build of the
    source, through the wrapper's launch)."""
    gen = torch.Generator().manual_seed(seed)
    x = cs.k1_inputs(dtype, B, snd, rcv, N, L, gen, "cuda", mask)
    if rows is not None:  # copied edges get their original's features
        x["e"] = x["e"][:, torch.as_tensor(rows).cuda()].contiguous()
    E = len(snd)
    plan = fb.plan_segments(rcv, N, senders=snd).to("cuda")
    topo = (x["senders"], x["receivers"], x["mask"], N)
    e, sp, rp, w = x["e"], x["sp"], x["rp"], x["weights"]
    e2, agg, a1, a2, mu, isg = fb.fused_edge_block_fwd(e, sp, rp, w, *topo, plan=plan, save_streams=True)
    de2 = torch.randn(B, E, L, generator=gen).to(dtype).cuda()
    if mask is not None:
        de2 = de2 * x["mask"][:, None].to(dtype)  # masked rows' cotangent is dead
    dagg = torch.randn(B, N, 4 * L, generator=gen).cuda()
    drhs = fb.agg_cotangent_rhs(agg, dagg, x["receivers"], x["mask"], N)

    def k2(lib=None):
        if lib is None:
            return fb.fused_edge_block_bwd(e, sp, rp, w, de2, drhs, *topo, plan=plan)
        with torch.cuda.device(e.device):
            return fb._bwd_launch(0, e, sp, rp, None, w, de2, drhs, *topo, plan, lib=lib)

    def k3(lib=None):
        if lib is None:
            return fb.fused_edge_block_bwd_stream(e, a1, a2, mu, isg, w, de2, drhs, *topo, plan=plan)
        with torch.cuda.device(e.device):
            return fb._bwd_launch(1, e, None, None, (a1, a2, mu, isg), w, de2, drhs, *topo, plan, lib=lib)

    return {"K2": k2, "K3": k3}


def grad_cases(cs, fb, torch, snd, rcv, N):
    """The --grads cases, each on inputs from its own seed."""
    snd_m, rcv_m, mask_m = cs.masked_topology(snd, rcv, N)
    snd_t, rcv_t, rows, _ = cs.tie_topology(snd, rcv, N)
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        "B=21 bf16": lambda: bwd_case(cs, fb, torch, snd, rcv, N, bf16, 21, 10),
        "B=3 float32": lambda: bwd_case(cs, fb, torch, snd, rcv, N, f32, 3, 11),
        "masked tail B=3 bf16": lambda: bwd_case(cs, fb, torch, snd_m, rcv_m, N, bf16, 3, 12, mask=mask_m),
        "interior mask B=3 bf16": lambda: bwd_case(
            cs, fb, torch, snd, rcv, N, bf16, 3, 13, mask=cs.interior_mask(rcv)),
        "ties B=3 bf16": lambda: bwd_case(cs, fb, torch, snd_t, rcv_t, N, bf16, 3, 14, rows=rows),
    }


K2_NAMES = ("de", "dh", "dz2", "dz3", "a1", "a2", "dsp", "drp", "dpar")
K3_NAMES = ("de", "dh", "dz2", "dz3", "dsp", "drp", "dpar")
EXACT = ("de", "dh", "dz2", "dz3", "a1", "a2")


def hold_grads(torch, tag, outs, grads_dir):
    """Save this checkout's K2/K3 outputs and hold them against the others'."""
    os.makedirs(grads_dir, exist_ok=True)
    torch.save(outs, os.path.join(grads_dir, f"{tag}-grads.pt"))
    ok = True
    for path in sorted(glob.glob(os.path.join(grads_dir, "*-grads.pt"))):
        other = os.path.basename(path)[: -len("-grads.pt")]
        if other == tag:
            continue
        theirs = torch.load(path)
        for case, kernels in outs.items():
            for kname, named in kernels.items():
                notes, fine = [], True
                for name, got in named.items():
                    want = theirs[case][kname][name]
                    same = torch.equal(got, want)
                    if name in EXACT:
                        fine &= same
                        if not same:
                            notes.append(f"{name} DIFFERS")
                    elif name == "dpar":
                        rel = [float((got[k] - want[k]).norm()) / max(float(want[k].norm()), 1e-30)
                               for k in range(got.shape[0])]
                        fine &= max(rel) <= 1e-4
                        notes.append(f"dpar {'equal' if same else f'max rel L2 {max(rel):.3g}'}")
                    else:
                        close = bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * float(want.abs().max())).all())
                        fine &= close
                        notes.append(f"{name} {'equal' if same else ('close' if close else 'NOT CLOSE')}")
                ok &= fine
                print(f"[{tag}] {kname} {case} against {other}: {'ok' if fine else 'FAILED'}; "
                      f"a1/a2/de/dh/dz2/dz3 bit for bit {all(torch.equal(named[n], theirs[case][kname][n]) for n in EXACT if n in named)}; "
                      + ", ".join(notes), flush=True)
    return ok


def probe_phases(lib, prefix, run, name, tag, cs, kernels):
    """Phase shares of one kernel from its probe build ``lib`` (``prefix``:
    the C reader's, ``hgn_fused_block_fwd`` or ``hgn_fused_block_bwd``);
    ``run(lib)`` launches it once."""
    read = getattr(lib, f"{prefix}_phases")
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    names_fn = getattr(lib, f"{prefix}_phase_names")
    names_fn.argtypes, names_fn.restype = [], ctypes.c_char_p
    names = names_fn().decode().split(",")
    buf = (ctypes.c_ulonglong * (len(names) + 1))()
    run(lib)
    read(buf, len(buf))  # clear
    iters = 5
    for _ in range(iters):
        run(lib)
    n = read(buf, len(buf))
    if n != len(names):
        raise RuntimeError(f"phase probe returned {n}")
    cycles, tiles = list(buf)[:n], buf[n]
    total = sum(cycles)
    ms = cs.kernel_device_ms(lambda: run(lib), iters=10, names=kernels)
    shares = ", ".join(f"{k} {100.0 * c / total:.1f}%" for k, c in zip(names, cycles))
    print(f"[{tag}] {name} phases (probe build, {iters} calls, {tiles // iters} tiles a call): {shares}; "
          f"{total / max(tiles, 1):.0f} cycles per tile and team; probe build main kernel "
          f"{ms * 1e3:.1f} us traced", flush=True)


def bwd_phases(fb, torch, run, name, tag, cs):
    """K2's or K3's phase shares from the probe build."""
    probe_phases(fb._lib(fb.BWD_SOURCE, BWD_PHASES), "hgn_fused_block_bwd", run, name, tag, cs,
                 cs.BWD_KERNELS[:1])


def f32_shapes(cs, torch):
    """The float32 shapes: ``(tag, senders, receivers, mask, plan, rows, B,
    mode)``, mode "full" (K1 and K2), "raw" (K1 raw and K2: a sharded step's
    shard) or "k2" (K2 only)."""
    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.parallel.group import RankGroup
    from hyper_graph_nets_tpu_torch.parallel.sharding import shard_topology
    from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

    host = lambda t: t.cpu().numpy()
    shapes, topos = [], {}
    for name in ("cylinder", "plate"):
        model = get_model(cs.model_config(name))
        topo = model.topology_from_trajectory(cs.model_trajectory(name, 0, 4), device="cuda")
        topos[name] = topo
        for B in (cs.MODEL_FRAMES, 1):
            shapes.append((f"{name} B={B}", host(topo.senders), host(topo.receivers), None, topo.plan,
                           topo.num_nodes, B, "full"))
    config = cs.hgn_config(fused_tiers=True)
    model = get_model(config)
    traj = cs.model_trajectory("plate", 0, 4)
    topo = model.topology_from_trajectory(traj, device="cuda")
    (static,) = build_expansion(model, config).prepare(model, {k: v[0] for k, v in traj.items()}, topo)
    rows = topo.num_nodes + cs.HGN_CLUSTERS
    shapes.append((f"HGN plate mesh B={cs.MODEL_FRAMES}", host(topo.senders), host(topo.receivers), None,
                   static.mesh_plan, rows, cs.MODEL_FRAMES, "full"))
    for name, plan in cs._tier_plans(static).items():
        prefix = cs.HGN_TIER_PLANS[name][: -len("_plan")]
        if prefix == "inter":  # bound by its bytes, not by the products
            continue
        snd, rcv, mask = (host(getattr(static, f"{prefix}_{f}")) for f in ("senders", "receivers", "mask"))
        shapes.append((f"HGN plate {prefix} B={cs.MODEL_FRAMES}", snd, rcv, mask, plan, rows, cs.MODEL_FRAMES,
                       "full"))
    for name in ("cylinder", "plate"):
        stopo = shard_topology(topos[name], RankGroup(2, 2, devices=["cuda:0"] * 4))
        per = stopo.layout.per
        cut = lambda t: host(t[:per])
        shapes.append((f"{name} 2x2 shard B=8", cut(stopo.senders), cut(stopo.receivers), cut(stopo.mask),
                       stopo.plan.plans[0], topos[name].num_nodes, 8, "raw"))
    stopo = shard_topology(topos["cylinder"], RankGroup(1, 4, devices=["cuda:0"] * 4), overlap_bands=cs.HALO_BANDS)
    per = stopo.layout.per
    shapes.append(("cylinder 1x4 overlap shard B=8", host(stopo.senders[:per]), host(stopo.receivers[:per]),
                   host(stopo.mask[:per]), stopo.plan.plans[0], topos["cylinder"].num_nodes, 8, "k2"))
    return shapes


def f32_case(cs, fb, torch, tag, shape, peaks, seed, phases):
    """Check and time float32 K1 (raw on a shard), K2 and, at cylinder
    B=16, K3 on one shape; False if a check failed."""
    name, snd, rcv, mask, plan, rows, B, mode = shape
    f32 = torch.float32
    x = cs.k1_inputs(f32, B, snd, rcv, rows, L, torch.Generator().manual_seed(seed), "cuda", mask=mask)
    topo = (x["senders"], x["receivers"], x["mask"], rows)
    e, sp, rp, w = x["e"], x["sp"], x["rp"], x["weights"]
    E, raw = len(snd), mode == "raw"
    has_f64 = hasattr(cs, "hold_to_f64")
    wide = lambda t: t.double()
    ok = True
    fwd = fb.fused_edge_block_fwd(e, sp, rp, w, *topo, plan=plan, save_streams=True)
    gen = torch.Generator().manual_seed(seed + 1)
    de2 = torch.randn(B, E, L, generator=gen).cuda()
    dagg = torch.randn(B, rows, 4 * L, generator=gen).cuda()
    drhs = fb.agg_cotangent_rhs(fwd[1], dagg, x["receivers"], x["mask"], rows, plan.degree)
    bounds = lambda kind, *a: (cs.k1_bound_ms if kind == "K1" else cs.bwd_bound_ms)(*a)

    def note(kname, run, kernels, plain, iters, ks):
        ms = cs.kernel_device_ms(run, iters=iters, names=kernels)
        plain_ms = cs.cuda_time_ms(plain, iters=3)
        args = (B, E, rows, L, peaks) + (() if kname.startswith("K1") else (kname == "K3",))
        bound = bounds(kname[:2], "float32", *args)[0]
        print(f"[{tag}] f32 {kname} {name} (E={E}, rows={rows}): {ms * 1e3:.1f} us traced, bound "
              f"{bound * 1e3:.2f} us, plain {plain_ms:.3f} ms{ks}", flush=True)

    try:
        if mode != "k2":
            k1 = lambda: fb.fused_edge_block_fwd(e, sp, rp, w, *topo, plan=plan, raw=raw)
            e2, agg = k1()
            re2, ragg = fb.fused_edge_block_reference(e, sp, rp, w, *topo, raw=raw)
            err = max(cs.check_close(f"K1 {name} e2", e2, re2, *cs.TOL["float32"]["e2"]),
                      cs.check_close(f"K1 {name} agg", agg, ragg, *cs.TOL["float32"]["agg"]))
            ks = f"; max abs err {err:.3g}"
            if has_f64:
                e2d, aggd = fb.fused_edge_block_reference(wide(e), wide(sp), wide(rp), w, *topo, raw=raw)
                ks += "; against float64 " + cs.f64_text(cs.hold_to_f64(f"K1 {name}", {"e2": (e2, re2, e2d)}))
                g, p = ((t.double() - aggd).abs().max().item() for t in (agg, ragg))
                ks += f", agg {g:.3g} (plain {p:.3g})"
                del e2d, aggd
            note("K1 raw" if raw else "K1", k1, "fused_block_fwd_kernel",
                 lambda: fb.fused_edge_block_reference(e, sp, rp, w, *topo, raw=raw), 20, ks)
        k2 = lambda: fb.fused_edge_block_bwd(e, sp, rp, w, de2, drhs, *topo, plan=plan)
        got = k2()
        want = fb.fused_edge_block_bwd_reference(e, sp, rp, w, de2, drhs, *topo, forward=(fwd[0], fwd[2], fwd[3]))
        order = lambda o: (o[0], o[1], o[2], o[3], o[6], o[7], o[8])
        err = cs.compare_bwd(f"K2 {name}", "float32", order(got), order(want))
        if not (torch.equal(got[4], fwd[2]) and torch.equal(got[5], fwd[3])):
            raise AssertionError(f"K2 {name}: the recomputed a1/a2 differ from K1's")
        ks = f"; max abs err {err:.3g}, a1/a2 equal K1's"
        if has_f64:
            want64 = fb.fused_edge_block_bwd_reference(wide(e), wide(sp), wide(rp), w, wide(de2), drhs, *topo,
                                                       forward=(fwd[0], fwd[2], fwd[3]))
            ks += "; against float64 " + cs.f64_text(cs.hold_to_f64(f"K2 {name}", {
                n: (got[i], want[i], want64[i]) for i, n in enumerate(("de", "dh", "dz2", "dz3"))}))
            del want64
        note("K2", k2, cs.BWD_KERNELS,
             lambda: fb.fused_edge_block_bwd_reference(e, sp, rp, w, de2, drhs, *topo), 10, ks)
        if name == f"cylinder B={cs.MODEL_FRAMES}":
            a1, a2, mu, isg = fwd[2:]
            k3 = lambda: fb.fused_edge_block_bwd_stream(e, a1, a2, mu, isg, w, de2, drhs, *topo, plan=plan)
            want3 = fb.fused_edge_block_bwd_stream_reference(e, a1, a2, mu, isg, w, de2, drhs, *topo, e2=fwd[0])
            err = cs.compare_bwd(f"K3 {name}", "float32", k3(), want3)
            note("K3", k3, cs.BWD_KERNELS, lambda: fb.fused_edge_block_bwd_stream_reference(
                e, a1, a2, mu, isg, w, de2, drhs, *topo), 10, f"; max abs err {err:.3g}")
            if phases:
                with torch.cuda.device(e.device):
                    bwd_phases(fb, torch, lambda lib: fb._bwd_launch(
                        0, e, sp, rp, None, w, de2, drhs, *topo, plan, lib=lib), f"K2 float32 {name}", tag, cs)
                lib = fb._lib(fb.FWD_SOURCE, FWD_PHASES)
                if hasattr(lib, "hgn_fused_block_fwd_phases"):
                    with torch.cuda.device(e.device):
                        probe_phases(lib, "hgn_fused_block_fwd", lambda lib: fb._k1_launch(
                            e, sp, rp, w, *topo, plan, False, False, lib=lib), f"K1 float32 {name}", tag, cs,
                            "fused_block_fwd_kernel")
    except AssertionError as err:
        print(f"[{tag}] f32 {name}: FAILED: {err}", flush=True)
        ok = False
    return ok


HALO_K6 = ((2, 6400, 128), (3, 6400, 128), (4, 6400, 128), (3, 1004, 37))


def _pna(rows):
    q = rows // 4
    return [(0, q, "sum"), (q, 2 * q, "sum"), (2 * q, 3 * q, "max"), (3 * q, 4 * q, "min")]


def halo_outputs(cs, torch):
    """K6's and K7's outputs on seeded inputs: ``{case: [tensors]}``."""
    from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap
    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments

    outs = {}
    for n, R, C in HALO_K6:
        gen = torch.Generator().manual_seed(100 + n + C)
        xs = [torch.randn(R, C, generator=gen).cuda() for _ in range(n)]
        group = cs.one_card_group(n)
        got = ring_all_reduce_segments(xs, _pna(R), group)
        group.check()
        outs[f"K6 n={n} [{R}, {C}]"] = [g.cpu() for g in got]
    for dtype_name in ("bfloat16", "float32"):
        shards, N = cs.overlap_shards(getattr(torch, dtype_name), torch.Generator().manual_seed(200))
        group = cs.one_card_group(len(shards))
        got = fused_edge_block_overlap(shards, N, group, cs.HALO_BANDS)
        group.check()
        outs[f"K7 {dtype_name} e2"] = [e2.cpu() for e2, _ in got]
        outs[f"K7 {dtype_name} agg"] = [agg.cpu() for _, agg in got]
    return outs


def hold_halo(torch, tag, outs, out_dir):
    """Save this checkout's K6/K7 outputs and hold them against the others':
    every tensor equal bit for bit."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(outs, os.path.join(out_dir, f"{tag}-halo.pt"))
    ok = True
    for path in sorted(glob.glob(os.path.join(out_dir, "*-halo.pt"))):
        other = os.path.basename(path)[: -len("-halo.pt")]
        if other == tag:
            continue
        theirs = torch.load(path)
        for case, tensors in outs.items():
            same = [torch.equal(a, b) for a, b in zip(tensors, theirs[case])]
            ok &= all(same)
            print(f"[{tag}] {case} against {other}: bit for bit on ranks "
                  f"{[r for r, x in enumerate(same) if x]} of {len(same)}", flush=True)
    return ok


def ring_phases(cs, torch, tag):
    """K6 and K7 from the phase-probe build, ungated and gated."""
    from hyper_graph_nets_tpu_torch.ops import fused_overlap as fo
    from hyper_graph_nets_tpu_torch.ops import ring

    lib6, lib7 = ring._lib(ring.SOURCE, ring.RING_PHASES), fo._lib(ring.RING_PHASES)
    runs = []
    for n in (2, 3, 4):
        gen = torch.Generator().manual_seed(300 + n)
        xs = [torch.randn(6400, 128, generator=gen).cuda() for _ in range(n)]
        group = cs.one_card_group(n)
        runs.append((f"K6 n={n}", group, lambda xs=xs, group=group: ring.ring_all_reduce_segments(
            xs, _pna(6400), group, lib=lib6), lib6))
    shards, N = cs.overlap_shards(torch.bfloat16, torch.Generator().manual_seed(301))
    group = cs.one_card_group(len(shards))
    runs.append(("K7 bf16", group, lambda: fo.fused_edge_block_overlap(shards, N, group, cs.HALO_BANDS, lib=lib7),
                 lib7))
    for name, group, run, lib in runs:
        for mode in ("ungated", "gated"):
            for _ in range(3):
                run()
            group.check()
            ring.read_phases(lib)  # clear
            if mode == "gated":
                ms = cs.gated_time_ms(group, run, iters=20, warmup=0)[0]
            else:
                ms = cs.group_time_ms(group, run, iters=20, warmup=0)
            phases, ctas, comp, groups = ring.read_phases(lib)
            total = sum(phases.values())
            shares = ", ".join(f"{k} {100.0 * c / max(total, 1):.1f}%" for k, c in phases.items() if c)
            comp_note = f"; compute {comp / max(groups, 1):.0f} cycles per group" if groups else ""
            print(f"[{tag}] {name} phases ({mode}, probe build, {ms * 1e3:.1f} us per call): {shares}; "
                  f"{total / max(ctas, 1):.0f} cycles per ring CTA and call{comp_note}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--halo", action="store_true")
    ap.add_argument("--e2", metavar="DIR")
    ap.add_argument("--grads", metavar="DIR")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--ring-phases", action="store_true")
    ap.add_argument("--halo-out", metavar="DIR")
    ap.add_argument("--f32", action="store_true")
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
    snd, rcv, N = edges.senders, edges.receivers, 1600
    runs = k1_runs(cs, fb, torch, snd, rcv, N)
    bwd = bwd_case(cs, fb, torch, snd, rcv, N, torch.bfloat16, 21, 1)
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
    if args.grads:
        outs = {}
        for case, make in grad_cases(cs, fb, torch, snd, rcv, N).items():
            ks = make()
            outs[case] = {
                name: dict(zip(names, (t.cpu() for t in ks[name]())))
                for name, names in (("K2", K2_NAMES), ("K3", K3_NAMES))
            }
            del ks
        ok &= hold_grads(torch, args.tag, outs, os.path.abspath(args.grads))
        del outs
    for _ in range(2):
        for k, run in runs.items():
            run(); torch.cuda.synchronize()
            ms = cs.kernel_device_ms(run, iters=20, names="fused_block_fwd_kernel")
            print(f"[{args.tag}] K1 {k}: {ms * 1e3:.1f} us traced", flush=True)
        for name, run in bwd.items():
            parts = [cs.kernel_device_ms(run, iters=10, names=n) for n in cs.BWD_KERNELS]
            both = cs.kernel_device_ms(run, iters=10, names=cs.BWD_KERNELS)
            print(f"[{args.tag}] {name} B=21: {both * 1e3:.1f} us traced (" + ", ".join(
                f"{n} {ms * 1e3:.1f}" for n, ms in zip(cs.BWD_KERNELS, parts)) + ")", flush=True)
        ms = cs.kernel_device_ms(lambda: maxprod(xa, ya), iters=20, names="maxprod_kernel")
        print(f"[{args.tag}] K5 random 1600^3: {ms * 1e3:.1f} us traced", flush=True)
    if args.phases:
        for name, run in bwd.items():
            bwd_phases(fb, torch, run, name, args.tag, cs)
    if args.f32:
        peaks = cs.peaks_for(torch.cuda.get_device_name(0))
        for k, shape in enumerate(f32_shapes(cs, torch)):
            ok &= f32_case(cs, fb, torch, args.tag, shape, peaks, 40 + k, args.phases)
            torch.cuda.empty_cache()
    if args.halo_out:
        ok &= hold_halo(torch, args.tag, halo_outputs(cs, torch), os.path.abspath(args.halo_out))
    if args.halo:
        card, peaks = cs.nvidia_smi(), cs.peaks_for(torch.cuda.get_device_name(0))
        cs.log = lambda msg: print(f"[{args.tag}] {msg}", flush=True)
        cs.phase_ring(card, peaks, 0)
        cs.phase_overlap(card, peaks, 0)
    if args.ring_phases:
        ring_phases(cs, torch, args.tag)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
