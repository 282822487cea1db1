#!/usr/bin/env python
"""Per-op device-vs-CPU ULP parity sweep (r3 verdict Missing #3).

The device fidelity matrix attributes a residual non-bitwise pixel
fraction (~26% on c3, identical across decomposition variants) to a
"device-FP class" — legal per-op f32 differences between the device and
the strict-FP CPU oracle. This tool converts that narrative into a
measurement: it sweeps the primitive ops the shading/march chains are
built from, plus the full shared shading equation, over representative
f32 ranges, and reports max/quantile ULP distance between

    device   — the op evaluated by the CURRENT jax backend (run on the
               GPU for the real matrix; XLA-CPU is itself a useful
               baseline for the legal-fusion class)
    strict   — NumPy f32 two-step evaluation (the golden oracles'
               semantics: -ffp-contract=off, separate round per op)
    correct  — float64 evaluation rounded once to f32 (the correctly-
               rounded reference, so `strict` and `device` each get an
               absolute accuracy number too)

Usage:  python tools/op_parity.py [--n 200000] [--json]

Interpretation: if device-vs-strict is <= k ULP per op over the swept
range, then a non-bitwise fidelity-matrix pixel whose rgb sits within
the composed k-ULP envelope is pinned to named ops, not hand-waved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _samples(n, rng):
    """Representative positive f32 magnitudes: log-uniform 1e-6..1e4,
    plus a dense band near 1.0 (directions/visibilities live there)."""
    a = np.exp(rng.uniform(np.log(1e-6), np.log(1e4), n // 2))
    b = rng.uniform(0.5, 2.0, n - n // 2)
    x = np.concatenate([a, b]).astype(np.float32)
    rng.shuffle(x)
    return x


def _signed(x, rng):
    s = np.where(rng.uniform(size=x.shape) < 0.5, -1.0, 1.0)
    return (x * s).astype(np.float32)


def _ulp(a, b):
    from surfjax.io.image import ulp_diff_f32
    return ulp_diff_f32(np.asarray(a, np.float32), np.asarray(b, np.float32))


def _report(name, dev, strict, correct):
    du_s = _ulp(dev, strict)
    du_c = _ulp(dev, correct)
    su_c = _ulp(strict, correct)
    row = {
        "op": name,
        "dev_vs_strict_max": int(du_s.max()),
        "dev_vs_strict_q999": float(np.quantile(du_s, 0.999)),
        "dev_vs_strict_frac_gt0": float((du_s > 0).mean()),
        "dev_vs_correct_max": int(du_c.max()),
        "strict_vs_correct_max": int(su_c.max()),
    }
    print(f"| {name:18s} | dev-vs-strict max {row['dev_vs_strict_max']:4d} "
          f"q99.9 {row['dev_vs_strict_q999']:6.1f} "
          f"frac>0 {row['dev_vs_strict_frac_gt0'] * 100:5.1f}% "
          f"| dev-vs-correct max {row['dev_vs_correct_max']:4d} "
          f"| strict-vs-correct max {row['strict_vs_correct_max']:4d} |")
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    print(f"backend: {jax.default_backend()}")
    rng = np.random.default_rng(0)
    n = args.n
    a = _signed(_samples(n, rng), rng)
    b = _signed(_samples(n, rng), rng)
    c = _signed(_samples(n, rng), rng)
    pos = _samples(n, rng)          # positive args for rsqrt/log
    unit = rng.uniform(0.0, 1.0, n).astype(np.float32)  # ndoth-like

    a64, b64, c64 = (x.astype(np.float64) for x in (a, b, c))
    pos64 = pos.astype(np.float64)
    unit64 = unit.astype(np.float64)

    rows = []

    def dev(f, *xs):
        return np.asarray(jax.jit(f)(*(jnp.asarray(x) for x in xs)))

    # mul-add chain a*b + c: XLA may contract to fma; strict is two
    # rounds; correct is the true fma (f64 exact for f32 inputs)
    rows.append(_report(
        "muladd(a*b+c)",
        dev(lambda a, b, c: a * b + c, a, b, c),
        (a * b + c).astype(np.float32),
        (a64 * b64 + c64).astype(np.float32)))

    # dot3 + normalize-style chain: x/sqrt(dot) in one jit (fusion zone)
    def norm_chain(x, y, z):
        d = (x * x + y * y) + z * z
        return x / jnp.sqrt(d)
    dd = ((a.astype(np.float32) * a + b * b) + c * c).astype(np.float32)
    rows.append(_report(
        "x/sqrt(xx+yy+zz)",
        dev(norm_chain, a, b, c),
        (a / np.sqrt(dd)).astype(np.float32),
        (a64 / np.sqrt((a64 * a64 + b64 * b64) + c64 * c64))
        .astype(np.float32)))

    rows.append(_report(
        "rsqrt(x)",
        dev(lambda x: lax.rsqrt(x), pos),
        (np.float32(1.0) / np.sqrt(pos)).astype(np.float32),
        (1.0 / np.sqrt(pos64)).astype(np.float32)))

    rows.append(_report(
        "sqrt(x)",
        dev(lambda x: jnp.sqrt(x), pos),
        np.sqrt(pos).astype(np.float32),
        np.sqrt(pos64).astype(np.float32)))

    rows.append(_report(
        "rcp(1/x)",
        dev(lambda x: jnp.float32(1.0) / x, pos),
        (np.float32(1.0) / pos).astype(np.float32),
        (1.0 / pos64).astype(np.float32)))

    small = np.clip(a, -20, 20).astype(np.float32)
    rows.append(_report(
        "exp(x)",
        dev(lambda x: jnp.exp(x), small),
        np.exp(small).astype(np.float32),
        np.exp(small.astype(np.float64)).astype(np.float32)))

    rows.append(_report(
        "log(x)",
        dev(lambda x: jnp.log(x), pos),
        np.log(pos).astype(np.float32),
        np.log(pos64).astype(np.float32)))

    # pow_int by squaring (the Blinn-Phong specular path, shininess 32)
    from surfjax.core.math import pow_int

    def pow_np(x, k):
        acc = np.ones_like(x)
        base = x.copy()
        while k:
            if k & 1:
                acc = (acc * base).astype(np.float32)
            base = (base * base).astype(np.float32)
            k >>= 1
        return acc

    def pow64(x, k):
        acc = np.ones_like(x, np.float64)
        base = x.astype(np.float64)
        while k:
            if k & 1:
                acc = acc * base
            base = base * base
            k >>= 1
        return acc

    # full [0,1] range: documents the denormal-output class (x^32 below
    # ~1e-38 — backends may flush-to-zero where strict NumPy keeps
    # denormals; visually irrelevant, but it IS an op-level difference)
    rows.append(_report(
        "pow_int(x,32)",
        dev(lambda x: pow_int(x, 32), unit),
        pow_np(unit, 32),
        pow64(unit64, 32).astype(np.float32)))
    # normal-output range: the regime that matters for visible speculars
    unit_n = (np.float32(0.1) + np.float32(0.9) * unit).astype(np.float32)
    rows.append(_report(
        "pow_int(x,32) x>=.1",
        dev(lambda x: pow_int(x, 32), unit_n),
        pow_np(unit_n, 32),
        pow64(unit_n.astype(np.float64), 32).astype(np.float32)))

    # the full shared shading equation (surfjax/shade.py) on plausible
    # inputs: unit-ish normals/light dirs, one light — the composite
    # chain whose bitwise disagreement the fidelity matrix reports
    nx, ny, nz = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    lx, ly, lz = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    vx, vy, vz = (rng.normal(size=n).astype(np.float32) for _ in range(3))

    def _nrm3(x, y, z, f64=False):
        t = np.float64 if f64 else np.float32
        x, y, z = x.astype(t), y.astype(t), z.astype(t)
        if f64:
            inv = 1.0 / np.sqrt((x * x + y * y) + z * z)
        else:
            inv = (np.float32(1.0)
                   / np.sqrt((x * x + y * y) + z * z).astype(np.float32))
        return x * inv, y * inv, z * inv

    mat = np.asarray([0.4, 0.6, 0.8, 0.1, 0.7, 0.5, 1.0, 1.0, 1.0],
                     np.float32)
    amb = (np.float32(1.0),) * 3
    lcol = (np.float32(1.0),) * 3
    vis = unit

    def shade_dev(nx, ny, nz, lx, ly, lz, vx, vy, vz, vis):
        from surfjax.shade import shade_object
        inv_n = jnp.float32(1.0) / jnp.sqrt((nx * nx + ny * ny) + nz * nz)
        nrm = (nx * inv_n, ny * inv_n, nz * inv_n)
        inv_l = jnp.float32(1.0) / jnp.sqrt((lx * lx + ly * ly) + lz * lz)
        ldir = (lx * inv_l, ly * inv_l, lz * inv_l)
        inv_v = jnp.float32(1.0) / jnp.sqrt((vx * vx + vy * vy) + vz * vz)
        vdir = (vx * inv_v, vy * inv_v, vz * inv_v)
        r, g, bb = shade_object(jnp.asarray(mat), 32, amb,
                                jnp.float32(1.0), nrm, vdir,
                                [(ldir, lcol, vis)])
        return r

    def shade_np(f64):
        t = np.float64 if f64 else np.float32
        one, zero = t(1.0), t(0.0)
        nrm = _nrm3(nx, ny, nz, f64)
        ldir = _nrm3(lx, ly, lz, f64)
        vdir = _nrm3(vx, vy, vz, f64)
        m = mat.astype(t)
        ndotl = np.maximum((nrm[0] * ldir[0] + nrm[1] * ldir[1])
                           + nrm[2] * ldir[2], zero).astype(t)
        hx = (ldir[0] + vdir[0]).astype(t)
        hy = (ldir[1] + vdir[1]).astype(t)
        hz = (ldir[2] + vdir[2]).astype(t)
        hh = np.maximum(((hx * hx + hy * hy) + hz * hz).astype(t), t(1e-20))
        inv_h = (one / np.sqrt(hh)).astype(t)
        ndoth = np.maximum((nrm[0] * (hx * inv_h) + nrm[1] * (hy * inv_h))
                           + nrm[2] * (hz * inv_h), zero).astype(t)
        spec = (m[5] * (pow64(ndoth, 32) if f64
                        else pow_np(ndoth.astype(np.float32), 32))).astype(t)
        diff = (m[4] * ndotl).astype(t)
        r = (m[3] * m[0] * one * one).astype(t)
        r = (r + vis.astype(t) * one * (diff * m[0] + spec * m[6])).astype(t)
        return r.astype(np.float32)

    rows.append(_report(
        "shade_chain(r)",
        dev(shade_dev, nx, ny, nz, lx, ly, lz, vx, vy, vz, vis),
        shade_np(False),
        shade_np(True)))

    if args.json:
        print(json.dumps({"backend": jax.default_backend(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
