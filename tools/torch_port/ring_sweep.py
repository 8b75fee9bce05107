"""K6 and K7 gated times of the ring's design choices, on the H100, for the
checkout the command runs in.

Run from the root of a checkout, on an H100:

    python tools/torch_port/ring_sweep.py

Each variant is a tuning build of ``csrc/ring.cu`` and
``csrc/fused_overlap.cu`` (a library of its own, never the main path's) or
another split of K7's CTAs, timed gated (``chip_smoke.gated_time_ms``: every
rank's launch queued before the first starts) at the main path's shapes on
one card: K6 at [6,400, 128] float32 over 2, 3 and 4 ranks with the pna
segments, K7 bf16 on the 40x40 flag's four overlap shards.  Every variant's
outputs must equal the main build's bit for bit (exit 1 if not).

- ``main``: the main path's build (64 KB chunks, card-scope flags on one card);
- ``chunk 16 KB``: ``-DHGN_RING_CHUNK=4096``;
- ``system scope``: ``-DHGN_RING_SYS_SCOPE``, the flags a group over several
  cards uses, on one card;
- ``K7 ring CTAs M``: M of a rank's CTAs ring (the main path's
  ``fused_overlap.ring_ctas`` gives 16 of 33), built as ``main``.
"""
import os
import sys
import threading

BUILDS = {
    "main": (),
    "chunk 16 KB": ("HGN_RING_CHUNK=4096",),
    "system scope": ("HGN_RING_SYS_SCOPE",),
}
K7_SPLITS = (8, 12, 20, 24)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from hyper_graph_nets_tpu_torch.ops import build, ring
    from hyper_graph_nets_tpu_torch.ops import fused_overlap as fo

    sources = [build.source_path(ring.SOURCE), build.source_path(fo.SOURCE)]
    errors = []

    def compile_(defines):
        try:
            build.build(sources, defines)
        except RuntimeError as exc:
            errors.append(f"{defines}: {exc}")

    threads = [threading.Thread(target=compile_, args=(d,)) for d in BUILDS.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    pna = lambda R: [(0, R // 4, "sum"), (R // 4, R // 2, "sum"), (R // 2, 3 * R // 4, "max"),
                     (3 * R // 4, R, "min")]
    gen = torch.Generator().manual_seed(5)
    xs = {n: [torch.randn(6400, 128, generator=gen).cuda() for _ in range(n)] for n in (2, 3, 4)}
    groups = {n: cs.one_card_group(n) for n in (2, 3, 4)}
    shards, N = cs.overlap_shards(torch.bfloat16, torch.Generator().manual_seed(6))
    g7 = cs.one_card_group(len(shards))
    want6 = {n: ring.ring_all_reduce_segments(xs[n], pna(6400), groups[n]) for n in (2, 3, 4)}
    want7 = fo.fused_edge_block_overlap(shards, N, g7, cs.HALO_BANDS)
    g7.check()
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    ok = True
    split = fo.ring_ctas
    variants = [(name, d, None) for name, d in BUILDS.items()] + [
        (f"K7 ring CTAs {m}", (), m) for m in K7_SPLITS]
    for turn in range(2):
        for name, defines, m in variants:
            lib6, lib7 = ring._lib(ring.SOURCE, defines), fo._lib(defines)
            fo.ring_ctas = split if m is None else (lambda bands, grid, m=m: m)
            try:
                line = []
                if m is None:
                    for n in (2, 3, 4):
                        run6 = lambda n=n: ring.ring_all_reduce_segments(xs[n], pna(6400), groups[n], lib=lib6)
                        got = run6()
                        groups[n].check()
                        ok &= same(got, want6[n])
                        line.append(f"K6 n={n} {cs.gated_time_ms(groups[n], run6, 50)[0] * 1e3:.1f}")
                run7 = lambda: fo.fused_edge_block_overlap(shards, N, g7, cs.HALO_BANDS, lib=lib7)
                got = run7()
                g7.check()
                ok &= all(same(a, b) for a, b in zip(got, want7))
                line.append(f"K7 bf16 {cs.gated_time_ms(g7, run7, 20)[0] * 1e3:.1f}")
            finally:
                fo.ring_ctas = split
            print(f"turn {turn} {name}: us per call, gated: " + ", ".join(line), flush=True)
    if not ok:
        print("a variant's outputs differ from the main build's", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
