"""A numpy model of float32 products on tensor cores at float32 accuracy
(3xTF32) against an ordered float32 fmaf chain, both held against float64,
on the CPU.

    python tools/torch_port/tf32x3_error.py [--rows 64] [--k 128] [--cols 64] [--seed 0]

The float32 products of K1, K2 and K3 keep the ordered fmaf chain
(``csrc/fused_block_common.cuh``): a 3xTF32 chain was built and measured on
the card, and though its error against float64 was below the fmaf chain's,
its e2 moved a few units in the last place off the plain version's and a
long segment's float32 sum out of the aggregate's tolerance (PERF.md).
This model is the accuracy prediction made for that design.

x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, nearest, ties
away) and lo = x - hi; a k step of eight is three mma.sync m16n8k8:
``acc = acc + ah*bh`` (a fresh tensor-core sum added in float32) and
``sm = sm + al*bh + ah*bl`` (carried in the tensor core), the product
acc + sm.  The tensor core's own sum is modelled three ways, since its
rounding is not documented: the eight products and the addend summed
exactly and rounded to nearest (``rn``), or aligned to the largest term and
truncated with 3 or 0 guard bits, then truncated to float32 (``trunc3``,
``trunc0``).  Also shown: all three terms in one sum, fresh every k step,
every 32 k, or carried over all k.

Prints, for each, the largest and the RMS error over the output as a
fraction of the largest |output|.  A model, not a measurement.
"""
import argparse

import numpy as np


def tf32_rna(x):
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def round_toward_zero(x):
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def mma(acc, a, b, model):
    """acc [R, N] + a [R, 8] @ b [8, N], one m16n8k8 under ``model``."""
    terms = np.concatenate([acc[:, None, :].astype(np.float64),
                            a[:, :, None].astype(np.float64) * b[None].astype(np.float64)], axis=1)
    if model == "rn":
        return terms.sum(1).astype(np.float32)
    guard = {"trunc3": 3, "trunc0": 0}[model]
    top = np.abs(terms).max(axis=1, keepdims=True)
    q = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23 - guard)
    return round_toward_zero((np.trunc(terms / q) * q).sum(1))


def fmaf_chain(a, w):
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64) + a[:, k : k + 1].astype(np.float64) * w[k]).astype(np.float32)
    return acc


def tf32x3(a, w, model, chunk):
    """The step over k in order, a fresh tensor-core sum every ``chunk`` k."""
    ah = tf32_rna(a)
    al = (a - ah).astype(np.float32)  # the tensor core reads its top 19 bits
    wh = tf32_rna(w)
    wl = (w - wh).astype(np.float32)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    t = acc
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        if k0 % chunk == 0:
            t = np.zeros_like(acc)
        t = mma(t, tf32_rna(al[:, s]), wh[s], model)
        t = mma(t, ah[:, s], tf32_rna(wl[s]), model)
        t = mma(t, ah[:, s], wh[s], model)
        if (k0 + 8) % chunk == 0:
            acc = (acc + t).astype(np.float32)
    return acc


def tf32x3_carried(a, w, model):
    """The large term a fresh tensor-core sum each k step added in float32,
    the two small terms carried in the tensor core over all k and added once
    at the end."""
    ah = tf32_rna(a)
    al = (a - ah).astype(np.float32)
    wh = tf32_rna(w)
    wl = (w - wh).astype(np.float32)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    small = np.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        small = mma(small, tf32_rna(al[:, s]), wh[s], model)
        small = mma(small, ah[:, s], tf32_rna(wl[s]), model)
        acc = (acc + mma(np.zeros_like(acc), ah[:, s], wh[s], model)).astype(np.float32)
    return (acc + small).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--cols", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    # K1's inputs in chip_smoke.k1_inputs: activations N(0, 1), weights U(-1, 1) / sqrt(L)
    a = rng.standard_normal((args.rows, args.k)).astype(np.float32)
    w = ((rng.random((args.k, args.cols)) * 2 - 1) / np.sqrt(args.k)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()

    def report(name, got):
        err = got.astype(np.float64) - exact
        print(f"{name:<52} max {np.abs(err).max() / scale:.3g}  rms {np.sqrt((err ** 2).mean()) / scale:.3g}")

    report("float32 fmaf chain", fmaf_chain(a, w))
    for model in ("rn", "trunc3", "trunc0"):
        for chunk, what in ((8, "fresh sum a k step"), (32, "fresh sum every 32 k"),
                            (args.k, "one tensor-core sum")):
            report(f"3xTF32 {model}, {what}", tf32x3(a, w, model, chunk))
        report(f"3xTF32 {model}, large fresh, small carried", tf32x3_carried(a, w, model))


if __name__ == "__main__":
    main()
