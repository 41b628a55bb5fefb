"""The rounding of the copy-score forward kernel's T > 1 arithmetic,
emulated on the CPU.

    python -m fira_tpu_torch.ops.emulate_fwd

The tile kernel of ``csrc/copy_score.cu`` takes tanh(src + tgt) as
1 - 2 / (e^(2 src) e^(2 tgt) + 1), with one reciprocal shared by each pair
of neighbouring d. This script replays that arithmetic in numpy f32 at the
training T, S and D (batch 2), on the inputs of the kernel's GPU tests
(``tests/test_torch_gpu.py``: standard normal src and tgt, w = 0.1 randn,
from ``numpy.random.default_rng(0)``), and prints one JSON line: the
largest absolute error against an f64 reference of one reciprocal a pair
of d and one a d, each with correctly rounded reciprocals and with
reciprocals moved by up to 1 ulp (as ``rcp.approx`` may), and of the plain
f32 version. It tests no code of the port: it is the numeric argument for
the pairing, beside the kernel's own tests on the card.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from fira_tpu_torch.config import fira_full

SHAPE = (2, fira_full().tar_len, 370, 256)


def emulate_tile_kernel(src, tgt, w, paired=True, perturb=None):
    """The T > 1 kernel's arithmetic for f32 numpy inputs, in numpy f32:
    e^(2 src) and e^(2 tgt) once each, then per pair of d (or per d when
    not ``paired``) fmaf(es, et, 1), the pair's numerator and product, one
    reciprocal, and the sum in d order; fmaf is rounded once (an f64
    product of two f32 values is exact). ``perturb``, a numpy Generator,
    moves each reciprocal by -1, 0 or +1 ulp."""
    f32 = np.float32

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f32)

    def rcp(x):
        r = (1.0 / x.astype(np.float64)).astype(f32)
        if perturb is not None:
            step = perturb.integers(-1, 2, size=r.shape)
            r = np.where(step > 0, np.nextafter(r, f32(np.inf)),
                         np.where(step < 0, np.nextafter(r, f32(-np.inf)), r))
        return r

    es = np.exp(2 * src)[:, None]          # (B, 1, S, D)
    et = np.exp(2 * tgt)[:, :, None]       # (B, T, 1, D)
    wn = (-2 * w).astype(f32)
    acc = np.zeros((src.shape[0], tgt.shape[1], src.shape[1]), f32)
    for d in range(0, w.size, 2 if paired else 1):
        a = fma(es[..., d], et[..., d], f32(1))
        if paired:
            b = fma(es[..., d + 1], et[..., d + 1], f32(1))
            num = fma(np.full_like(b, wn[d]), b, (wn[d + 1] * a).astype(f32))
            acc = fma(num, rcp((a * b).astype(f32)), acc)
        else:
            acc = fma(np.full_like(a, wn[d]), rcp(a), acc)
    wsum = f32(0)
    for x in w:
        wsum = f32(wsum + x)
    return (wsum + acc).astype(f32)


def emulated_errors(shape=SHAPE, seed=0) -> dict:
    """Largest absolute error against f64 of the emulated kernel (one
    reciprocal a pair of d, and one a d; exact and perturbed reciprocals)
    and of the plain f32 version."""
    B, T, S, D = shape
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S, D), np.float32)
    tgt = rng.standard_normal((B, T, D), np.float32)
    w = (rng.standard_normal((D, 1), np.float32) * 0.1)[:, 0]
    ref = np.einsum("btsd,d->bts", np.tanh(
        src.astype(np.float64)[:, None] + tgt[:, :, None]), w)
    plain = np.tanh(src[:, None] + tgt[:, :, None]) @ w
    errs = {"plain": float(np.abs(plain - ref).max())}
    for paired in (True, False):
        for name, gen in (("exact", None),
                          ("perturbed", np.random.default_rng(seed))):
            got = emulate_tile_kernel(src, tgt, w, paired, gen)
            errs[f"{'pairs' if paired else 'single'}_{name}"] = float(
                np.abs(got - ref).max())
    return errs


def main() -> int:
    print(json.dumps(dict(shape=SHAPE, **emulated_errors())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
