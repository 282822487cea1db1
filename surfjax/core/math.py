"""Core vector/ray math (SURVEY.md §2 component 1).

Everything here is written against an *abstract* array namespace so the same
formulas — in the exact same floating-point evaluation order — run under
`jax.numpy` (the device path) and under plain `numpy` only via the golden
renderer's own independent implementation (which deliberately does NOT import
this module; see surfjax/golden/).

FP discipline (SURVEY.md §7 hard part 1):
  * float32 everywhere;
  * dot products are evaluated as ((x*x + y*y) + z*z) — fixed left-to-right
    association, never `sum()`;
  * `normalize` is v * (1/sqrt(dot(v,v)));
  * integer powers (Blinn-Phong shininess) use repeated squaring, never
    `pow`, so libm vs XLA transcendental differences cannot appear.

Vectors are component triplets (x, y, z) of same-shape arrays (SoA), which is
both the parity-friendly representation and the layout the Pallas kernels use
(lane-major tiles).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# A large-but-finite sentinel used instead of inf so that arithmetic on miss
# lanes never produces NaNs inside masked kernels.
# NOTE: scalar constants are numpy float32 (not jnp) — jnp.float32(x) builds
# a 0-d device array, which Pallas kernel bodies may not capture.
BIG = np.float32(1e30)
F32 = np.float32


def f32(x):
    return jnp.asarray(x, jnp.float32)


# ---------------------------------------------------------------------------
# Vec3 ops. v = (x, y, z) tuple of arrays.
# ---------------------------------------------------------------------------

def vdot(a, b):
    """Fixed-association dot product: ((ax*bx + ay*by) + az*bz)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vlength(a):
    return jnp.sqrt(vdot(a, a))


def vnormalize(a):
    inv = F32(1.0) / jnp.sqrt(vdot(a, a))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def vreflect(d, n):
    """Reflect direction d about normal n: d - 2*dot(d,n)*n."""
    k = F32(2.0) * vdot(d, n)
    return (d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2])


def vwhere(mask, a, b):
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def vabs(a):
    return (jnp.abs(a[0]), jnp.abs(a[1]), jnp.abs(a[2]))


def vmax(a, b):
    return (jnp.maximum(a[0], b[0]), jnp.maximum(a[1], b[1]),
            jnp.maximum(a[2], b[2]))


def vmin(a, b):
    return (jnp.minimum(a[0], b[0]), jnp.minimum(a[1], b[1]),
            jnp.minimum(a[2], b[2]))


def vbroadcast(v, shape):
    """Broadcast a constant 3-vector (python floats) to array components."""
    return (jnp.full(shape, v[0], jnp.float32),
            jnp.full(shape, v[1], jnp.float32),
            jnp.full(shape, v[2], jnp.float32))


# ---------------------------------------------------------------------------
# Scalar helpers
# ---------------------------------------------------------------------------

def pow_int(x, n: int):
    """x**n for a static non-negative integer n, by repeated squaring.

    Produces an identical multiplication tree in golden and device paths, so
    Blinn-Phong shininess never touches a transcendental `pow`.
    """
    assert n >= 0 and int(n) == n
    n = int(n)
    if n == 0:
        return jnp.ones_like(x)
    result = None
    base = x
    while n:
        if n & 1:
            result = base if result is None else result * base
        n >>= 1
        if n:
            base = base * base
    return result


def clamp(x, lo, hi):
    return jnp.minimum(jnp.maximum(x, lo), hi)


def saturate(x):
    return jnp.minimum(jnp.maximum(x, F32(0.0)), F32(1.0))


def smoothstep(e0, e1, x):
    t = saturate((x - e0) / (e1 - e0))
    return t * t * (F32(3.0) - F32(2.0) * t)


def mix(a, b, t):
    return a + (b - a) * t


def quadratic_smallest_root(b_half, c):
    """Roots of t^2 + 2*b_half*t + c = 0 (monic, a=1 after normalizing d).

    Returns (t0, t1, has_roots) with t0 <= t1. On no real roots, (BIG, -BIG,
    False) — an empty interval. Uses the numerically-stable form
    q = -(b_half + sign(b_half)*sqrt(disc)); roots are q and c/q.
    """
    disc = b_half * b_half - c
    has = disc >= F32(0.0)
    sq = jnp.sqrt(jnp.maximum(disc, F32(0.0)))
    # sign(b_half): +1 if >= 0 else -1 (avoid sign(0)=0)
    s = jnp.where(b_half >= F32(0.0), F32(1.0), F32(-1.0))
    q = -(b_half + s * sq)
    r0 = q
    r1 = jnp.where(q != F32(0.0), c / q, -b_half)  # q==0 => b_half==0, c<=0
    t0 = jnp.minimum(r0, r1)
    t1 = jnp.maximum(r0, r1)
    t0 = jnp.where(has, t0, BIG)
    t1 = jnp.where(has, t1, -BIG)
    return t0, t1, has


# ---------------------------------------------------------------------------
# Bitwise-portable f32 log (r4 verdict Next #6).
#
# tools/op_parity.py measures jnp.log as the largest single-op
# cross-backend deviation (a device log can sit thousands of ULP from
# host libm), which perturbs every
# Mandelbulb DE value ~5e-4 rel in the epilogue and feeds the eps-band
# hit decorrelation behind the c3/c5 marched carve-out. This
# implementation uses ONLY ops that round identically everywhere
# (int bit ops, f32 mul/add/compare/select — each written as a separate
# two-round op; tools/op_parity.py checks a device for it, the NumPy and
# strict-FP C++ (-ffp-contract=off) goldens likewise), so the kernel and
# both oracles compute bit-identical logs by construction.
#
# Algorithm: x = f * 2^e with f in [sqrt(1/2), sqrt(2)); log(x) =
# e*ln2 + log1p(u), u = f-1; log1p(u) = u + u^2 * g(u) with g a
# degree-8 Chebyshev fit on the reduction interval (fit error 3.5e-9 in
# f64; full f32 two-round max abs error 1.9e-6 over [1e-30, 300] —
# ~1 ULP at the result's magnitude). ln2 is split hi/lo with e*LN2_HI
# exact (14-bit hi mantissa x |e| <= 2^7). Domain: NORMAL positive
# finite x (callers guard with max(x, 1e-30); 1e-30 > 2^-126).
# Association is FIXED — the NumPy mirror (golden/renderer.py) and the
# C++ mirror (golden/cpp/golden.cpp) replicate it op for op; pinned
# bitwise-identical in tests/test_portable_log.py.
# ---------------------------------------------------------------------------

# g(u) coefficients, ascending powers (f32-exact values; hex in the test)
_PLOG_C = (
    F32(-0.4999999701976776), F32(0.33333322405815125),
    F32(-0.2500077188014984), F32(0.2000196874141693),
    F32(-0.1662759929895401), F32(0.1418900042772293),
    F32(-0.131016343832016), F32(0.12821748852729797),
    F32(-0.07866667956113815),
)
_PLOG_LN2_HI = F32(0.6931457519531250)       # 0x3f317200
_PLOG_LN2_LO = F32(1.4286067653301955e-06)   # f32(ln2 - LN2_HI)
_PLOG_SQRTH = F32(0.7071067811865476)


def portable_log(x):
    """Bitwise-portable natural log of a normal positive f32 array (see
    block comment above). NOT a general log: no subnormal/0/inf/nan
    handling — callers guard the domain."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = ((bits >> 23) & jnp.int32(0xFF)) - jnp.int32(126)
    f = jax.lax.bitcast_convert_type(
        (bits & jnp.int32(0x007FFFFF)) | jnp.int32(0x3F000000), jnp.float32)
    small = f < _PLOG_SQRTH
    f = jnp.where(small, f + f, f)
    e = jnp.where(small, e - jnp.int32(1), e)
    ef = e.astype(jnp.float32)
    u = f - F32(1.0)
    g = jnp.full_like(u, _PLOG_C[8])
    for c in _PLOG_C[7::-1]:
        g = g * u + c
    u2 = u * u
    l1p = u + u2 * g
    return ef * _PLOG_LN2_HI + (l1p + ef * _PLOG_LN2_LO)
