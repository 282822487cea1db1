"""SDF engine: scene SDF evaluation + bounded sphere tracer (jnp twin).

SURVEY.md §2 components 5 (SDF engine), 6 (sphere tracer), 12 (soft
shadows), 13 (AO probes). BASELINE.json:5 "bounded sphere-tracing for SDFs
as a masked fixed-trip loop", :9 "Mandelbulb / smooth-min blends, soft
shadows + ambient occlusion".

This module is the pure-jax.numpy *twin* of the Pallas kernels
(surfjax/kernels/) — SURVEY.md §4.3 requires every kernel to have a jnp twin
for bitwise parity testing. The SDF tape is statically unrolled from the
SceneIR, so XLA sees straight-line vector code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from surfjax.core.math import (
    BIG, F32, clamp, mix, saturate, vdot, vnormalize, vsub,
)
from surfjax.core.scene_compile import (
    LEAF_BOX, LEAF_MANDELBULB, LEAF_PLANE, LEAF_SPHERE, ObjectIR,
)
from surfjax.api import (
    OP_LEAF, OP_UNION, OP_INTERSECT, OP_SUBTRACT,
    OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT,
)


# ---------------------------------------------------------------------------
# Leaf SDFs
# ---------------------------------------------------------------------------

def sdf_sphere(prm, p):
    c = (prm[0], prm[1], prm[2])
    q = vsub(p, c)
    return jnp.sqrt(vdot(q, q)) - prm[3]


def sdf_plane(prm, p):
    n = (prm[0], prm[1], prm[2])
    return vdot(n, p) - prm[3]


def sdf_box(prm, p):
    c = (prm[0], prm[1], prm[2])
    h = (prm[3], prm[4], prm[5])
    qx = jnp.abs(p[0] - c[0]) - h[0]
    qy = jnp.abs(p[1] - c[1]) - h[1]
    qz = jnp.abs(p[2] - c[2]) - h[2]
    ox = jnp.maximum(qx, F32(0.0))
    oy = jnp.maximum(qy, F32(0.0))
    oz = jnp.maximum(qz, F32(0.0))
    outside = jnp.sqrt((ox * ox + oy * oy) + oz * oz)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), F32(0.0))
    return outside + inside


def sdf_mandelbulb_general(prm, p, power: int, iterations: int):
    """General power-n Mandelbulb DE via the standard triplex-power trig
    form (z -> z^n + c with spherical-coordinate angle multiplication).
    Differentiable; lowers in XLA and through Pallas-Triton (acos/atan2/
    sin/cos), so every backend and the golden oracles use this form for
    power != 8."""
    c = (prm[0], prm[1], prm[2])
    scale = prm[3]
    bailout2 = prm[4] * prm[4] * F32(16.0)
    inv_s = F32(1.0) / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s
    n = F32(float(power))

    wx, wy, wz = px, py, pz
    m = (wx * wx + wy * wy) + wz * wz
    dz = jnp.ones_like(m)
    escaped = m > bailout2
    tiny = F32(1e-12)

    for _ in range(iterations):
        active = ~escaped
        r = jnp.sqrt(jnp.maximum(m, tiny))
        # dz' = n * r^(n-1) * dz + 1
        rp1 = jnp.exp(F32(float(power - 1)) * jnp.log(r))
        dz_new = n * rp1 * dz + F32(1.0)
        theta = jnp.arccos(jnp.clip(wz / r, F32(-1.0), F32(1.0))) * n
        phi = jnp.arctan2(wy, wx) * n
        zr = rp1 * r  # r^n
        st = jnp.sin(theta)
        wx_new = px + zr * (st * jnp.cos(phi))
        wy_new = py + zr * (st * jnp.sin(phi))
        wz_new = pz + zr * jnp.cos(theta)
        wx = jnp.where(active, wx_new, wx)
        wy = jnp.where(active, wy_new, wy)
        wz = jnp.where(active, wz_new, wz)
        dz = jnp.where(active, dz_new, dz)
        m = jnp.where(active, (wx * wx + wy * wy) + wz * wz, m)
        escaped = escaped | (m > bailout2)

    r = jnp.sqrt(jnp.maximum(m, tiny))
    de = F32(0.25) * jnp.log(jnp.maximum(m, tiny)) * r / dz
    # same far-field guard as the power-8 path (see sdf_mandelbulb)
    r0 = jnp.sqrt((px * px + py * py) + pz * pz)
    far = r0 - F32(1.35)
    de = jnp.where(far > F32(0.0),
                   jnp.minimum(de, far + F32(0.1)), de)
    return de * scale


def sdf_mandelbulb(prm, p, power: int, iterations: int):
    """Mandelbulb distance estimator (component 5).

    power == 8 uses the closed-form degree-8 triplex power expansion (the
    standard trigless formulation of z -> z^8 + c), so the iteration
    contains only +, *, /, sqrt — no acos/atan2/sin/cos, which keeps the
    golden-parity carve-out down to the single final log(). Other powers
    take the general trig form.
    """
    if power != 8:
        return sdf_mandelbulb_general(prm, p, power, iterations)
    c = (prm[0], prm[1], prm[2])
    scale = prm[3]
    bailout2 = prm[4] * prm[4] * F32(16.0)
    inv_s = F32(1.0) / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s

    wx, wy, wz = px, py, pz
    m = (wx * wx + wy * wy) + wz * wz
    dz = jnp.ones_like(m)
    escaped = m > bailout2
    tiny = F32(1e-4)  # k3^7 must not underflow f32

    for _ in range(iterations):
        active = ~escaped
        m2 = m * m
        m4 = m2 * m2
        dz_new = F32(8.0) * jnp.sqrt((m4 * m2) * m) * dz + F32(1.0)

        x, y, z = wx, wy, wz
        x2 = x * x
        x4 = x2 * x2
        y2 = y * y
        y4 = y2 * y2
        z2 = z * z
        z4 = z2 * z2
        k3 = x2 + z2
        k3s = jnp.maximum(k3, tiny)
        k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
        k2 = F32(1.0) / jnp.sqrt(k37)
        k1 = ((x4 + y4) + z4) - F32(6.0) * (y2 * z2) \
            - F32(6.0) * (x2 * y2) + F32(2.0) * (z2 * x2)
        k4 = (x2 - y2) + z2

        wx_new = px + F32(64.0) * ((((x * y) * z) * (x2 - z2)) * k4) \
            * ((x4 - F32(6.0) * (x2 * z2)) + z4) * k1 * k2
        wy_new = py + (F32(-16.0) * (y2 * k3) * (k4 * k4) + k1 * k1)
        wz_new = pz + F32(-8.0) * (y * k4) \
            * ((((x4 * x4) - F32(28.0) * ((x4 * x2) * z2))
                + F32(70.0) * (x4 * z4))
               - F32(28.0) * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2

        wx = jnp.where(active, wx_new, wx)
        wy = jnp.where(active, wy_new, wy)
        wz = jnp.where(active, wz_new, wz)
        dz = jnp.where(active, dz_new, dz)
        m = jnp.where(active, (wx * wx + wy * wy) + wz * wz, m)
        escaped = escaped | (m > bailout2)

    r = jnp.sqrt(m)
    # max(m, 1e-30): identical for every normal m; at m == 0 (evaluation
    # point maps to the origin — ON the set) log(0)*0 would be NaN, the
    # guard makes de exactly 0 (correct). Same literal guard in the
    # while form and both goldens so all four implementations agree.
    de = F32(0.25) * jnp.log(jnp.maximum(m, F32(1e-30))) * r / dz
    # far-field guard: the raw DE overestimates distance for far points
    # (escape at iteration ~0, dz ~ 1 => de ~ 0.5*r*ln r), which makes the
    # march overshoot INTO the set. The set lies in a ball of radius 1.25
    # (scaled), so dist >= |p| - 1.25 is a true lower bound; stepping by
    # it is always safe and the clamp only binds far away.
    # Floor the clamp at 0.1 so it can never satisfy the hit test and
    # create a phantom surface at the bound: stepping (r0-1.35)+0.1 from
    # radius r0 lands at radius >= 1.25 > the set's max radius ~1.2, so
    # the step is still safe.
    r0 = jnp.sqrt((px * px + py * py) + pz * pz)
    far = r0 - F32(1.35)
    de = jnp.where(far > F32(0.0),
                   jnp.minimum(de, far + F32(0.1)), de)
    return de * scale


# Bulb iterations per while trip. Unrolled iterations are value-exact
# (masked substeps are identity for escaped lanes); they trade code size
# and registers for fewer block-wide "all escaped" reductions. Not yet
# swept on the GPU (PERF.md, open questions).
DE_UNROLL = 4


def _bulb_while_driver(prm, p, power: int, iterations: int, new_w_builder,
                       log_fn=None):
    """Shared while-loop scaffold for the kernel-path Mandelbulb DEs.

    The std and cheb variants differ ONLY in the triplex z -> z^8 + c
    update (new_w_builder(px, py, pz, tiny) -> new_w(x, y, z) ->
    (wx_new, wy_new, wz_new)); everything else — escape semantics, the
    dz recurrence and its rsqrt(0) guard, the DE_UNROLL divisor rule,
    the log/far-field epilogue — lives here once so the variants cannot
    silently diverge (review r4).

    log_fn overrides the epilogue's log (None = jnp.log; the
    bitwise-portable core.math.portable_log under
    RenderSettings(bulb_log='portable') — r4 verdict Next #6).

    Exits as soon as every lane has escaped (f32 escape mask, scalar trip
    count). Per-trip cost trims (bitwise value-exact):
      - the escape mask is NOT a loop carry: once a lane's m crosses
        bailout2 every later update is masked off, so m is frozen above
        the bailout and `m > bailout2` IS the sticky escape state;
      - DE_UNROLL iterations run per while trip (masked substeps are
        identity for escaped lanes); the unroll actually used is the
        largest divisor of `iterations` that is <= DE_UNROLL so the
        trip bound stays exact.
    """
    if power != 8:
        # the closed-form expansion exists for power 8 only; the general
        # trig form is a fixed-trip loop with no early escape
        return sdf_mandelbulb_general(prm, p, power, iterations)
    c = (prm[0], prm[1], prm[2])
    scale = prm[3]
    bailout2 = prm[4] * prm[4] * F32(16.0)
    inv_s = F32(1.0) / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s
    m0 = (px * px + py * py) + pz * pz
    tiny = F32(1e-4)
    unroll = next(u for u in range(min(DE_UNROLL, iterations), 0, -1)
                  if iterations % u == 0)
    new_w = new_w_builder(px, py, pz, tiny)

    def cond(s):
        i, _, _, _, _, m = s
        return (i < iterations) & (jnp.min(
            jnp.where(m > bailout2, F32(1.0), F32(0.0))) < F32(0.5))

    def substep(wx, wy, wz, dz, m):
        active = m <= bailout2
        m2 = m * m
        m4 = m2 * m2
        # m^3.5 = m^4 * rsqrt(m); hardware rsqrt — this is the kernel-fast
        # path, and the Mandelbulb carries the chaos tolerance carve-out.
        # max(m, 1e-30): identical for normal m; at m == 0 rsqrt(0)=inf
        # times m4=0 would poison dz with NaN for the rest of the march
        # (the unrolled form's sqrt(m^7) path yields 0 there) — the
        # guard gives the same dz_new = 1.
        dz_new = F32(8.0) * ((m4 * jax.lax.rsqrt(
            jnp.maximum(m, F32(1e-30)))) * dz) + F32(1.0)
        wx_new, wy_new, wz_new = new_w(wx, wy, wz)
        wx = jnp.where(active, wx_new, wx)
        wy = jnp.where(active, wy_new, wy)
        wz = jnp.where(active, wz_new, wz)
        dz = jnp.where(active, dz_new, dz)
        m = jnp.where(active, (wx * wx + wy * wy) + wz * wz, m)
        return wx, wy, wz, dz, m

    def body(s):
        i, wx, wy, wz, dz, m = s
        for _ in range(unroll):
            wx, wy, wz, dz, m = substep(wx, wy, wz, dz, m)
        return i + unroll, wx, wy, wz, dz, m

    _, _, _, _, dz, m = jax.lax.while_loop(
        cond, body, (0, px, py, pz, jnp.ones_like(m0), m0))
    r = jnp.sqrt(m)
    # same m == 0 log guard as sdf_mandelbulb (de exactly 0 on the set;
    # it also pins the portable log's normal-positive domain)
    log_fn = log_fn or jnp.log
    de = F32(0.25) * log_fn(jnp.maximum(m, F32(1e-30))) * r / dz
    # far-field guard -- see sdf_mandelbulb
    r0 = jnp.sqrt(m0)
    far = r0 - F32(1.35)
    de = jnp.where(far > F32(0.0),
                   jnp.minimum(de, far + F32(0.1)), de)
    return de * scale


def _new_w_std(px, py, pz, tiny):
    """The standard trigless degree-8 triplex power expansion — the
    oracle-matching form (identical arithmetic to sdf_mandelbulb)."""
    def new_w(x, y, z):
        x2 = x * x
        x4 = x2 * x2
        y2 = y * y
        y4 = y2 * y2
        z2 = z * z
        z4 = z2 * z2
        k3 = x2 + z2
        k3s = jnp.maximum(k3, tiny)
        k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
        k2 = jax.lax.rsqrt(k37)
        k1 = ((x4 + y4) + z4) - F32(6.0) * (y2 * z2) \
            - F32(6.0) * (x2 * y2) + F32(2.0) * (z2 * x2)
        k4 = (x2 - y2) + z2
        wx_new = px + F32(64.0) * ((((x * y) * z) * (x2 - z2)) * k4) \
            * ((x4 - F32(6.0) * (x2 * z2)) + z4) * k1 * k2
        wy_new = py + (F32(-16.0) * (y2 * k3) * (k4 * k4) + k1 * k1)
        wz_new = pz + F32(-8.0) * (y * k4) \
            * ((((x4 * x4) - F32(28.0) * ((x4 * x2) * z2))
                + F32(70.0) * (x4 * z4))
               - F32(28.0) * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2
        return wx_new, wy_new, wz_new
    return new_w


def _new_w_cheb(px, py, pz, tiny):
    """Restructured power-8 update (r4 verdict Next #2b — fewer flops):

      - Re/Im((x+iz)^8) via THREE complex squarings (13 ops) replace the
        expanded degree-8 polynomials of wx_new/wz_new (~31 ops); both
        branches share S = 8*y*k4*k1*k2:
            wx' = px + S*Im(w^8),  wz' = pz - S*Re(w^8)
        (Im(w^8) = 8xz(x^2-z^2)(x^4-6x^2z^2+z^4), Re(w^8) the
        x^8-28x^6z^2+... expansion — verified to fp noise over 1e5
        random triples).
      - k1 = (k3-3y^2)^2 - 8y^4 replaces the 6-term expansion.

    Hand count: ~79 -> ~65 ops/iteration (~18%). Mathematically exact;
    f32 reassociation shifts each iterate by O(1 ulp), which the chaotic
    DE amplifies — hits land elsewhere in the eps band at silhouettes
    (the standard c3 carve-out class). Enable with
    RenderSettings(bulb_iter="cheb"); its parity with the jnp path on the
    card is checked by chip_smoke.py like every other trajectory change.
    """
    def new_w(x, y, z):
        x2 = x * x
        y2 = y * y
        z2 = z * z
        y4 = y2 * y2
        k3 = x2 + z2
        k3s = jnp.maximum(k3, tiny)
        k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
        k2 = jax.lax.rsqrt(k37)
        t13 = k3 - F32(3.0) * y2
        k1 = t13 * t13 - F32(8.0) * y4
        k4 = (x2 - y2) + z2
        # w^8 by three complex squarings of w = x + i z
        a1 = x2 - z2
        b1 = F32(2.0) * (x * z)
        a2 = a1 * a1 - b1 * b1
        b2 = F32(2.0) * (a1 * b1)
        re8 = a2 * a2 - b2 * b2
        im8 = F32(2.0) * (a2 * b2)
        s8 = ((F32(8.0) * y) * k4) * (k1 * k2)
        wx_new = px + s8 * im8
        wy_new = py + (F32(-16.0) * (y2 * k3) * (k4 * k4) + k1 * k1)
        wz_new = pz - s8 * re8
        return wx_new, wy_new, wz_new
    return new_w


def sdf_mandelbulb_while(prm, p, power: int, iterations: int):
    """The kernel-path bulb DE: standard trigless power-8 update under
    the shared early-exit while scaffold (_bulb_while_driver). Identical
    arithmetic to the unrolled sdf_mandelbulb (which stays
    reverse-differentiable for the IFT vjp)."""
    return _bulb_while_driver(prm, p, power, iterations, _new_w_std)


def sdf_mandelbulb_while_cheb(prm, p, power: int, iterations: int):
    """Kernel-path bulb DE with the restructured (cheaper) power-8
    update — see _new_w_cheb for the algebra, op counts and the
    fidelity caveat. RenderSettings(bulb_iter='cheb')."""
    return _bulb_while_driver(prm, p, power, iterations, _new_w_cheb)


def leaf_sdf(kind: int, prm, p, p0: int = 0, p1: int = 0):
    if kind == LEAF_SPHERE:
        return sdf_sphere(prm, p)
    if kind == LEAF_PLANE:
        return sdf_plane(prm, p)
    if kind == LEAF_BOX:
        return sdf_box(prm, p)
    if kind == LEAF_MANDELBULB:
        return sdf_mandelbulb(prm, p, p0, p1)
    raise ValueError(f"sdf engine: unsupported leaf kind {kind}")


def make_bulb_while(bulb_iter: str = "std", bulb_log: str = "hw"):
    """Kernel-path bulb DE factory: iteration form (std | cheb,
    RenderSettings.bulb_iter) x epilogue log (hw | portable,
    RenderSettings.bulb_log)."""
    from surfjax.core.math import portable_log
    new_w = _new_w_cheb if bulb_iter == "cheb" else _new_w_std
    log_fn = portable_log if bulb_log == "portable" else None

    def bulb(prm, p, power, iterations):
        return _bulb_while_driver(prm, p, power, iterations, new_w,
                                  log_fn=log_fn)
    return bulb


def make_leaf_fast(bulb_iter: str = "std", bulb_log: str = "hw"):
    """Kernel-path leaf evaluator for the given bulb variant flags."""
    bulb = make_bulb_while(bulb_iter, bulb_log)

    def leaf_fn(kind, prm, p, p0=0, p1=0):
        if kind == LEAF_MANDELBULB:
            return bulb(prm, p, p0, p1)
        return leaf_sdf(kind, prm, p, p0, p1)
    return leaf_fn


# compat aliases (tests + older tools import these names)
leaf_sdf_fast = make_leaf_fast("std", "hw")
leaf_sdf_fast_cheb = make_leaf_fast("cheb", "hw")


# ---------------------------------------------------------------------------
# CSG tape over SDF values (smooth-min blends: Quilez polynomial forms)
# ---------------------------------------------------------------------------

def eval_sdf(oir: ObjectIR, leaf_params, node_params, p, leaf_fn=None):
    """Object SDF at points p = (x, y, z) arrays. Statically unrolled tape.

    leaf_fn overrides leaf evaluation (kernels pass leaf_sdf_fast).
    """
    leaf_fn = leaf_fn or leaf_sdf
    vals = []
    for nd in oir.nodes:
        if nd.op == OP_LEAF:
            lf = oir.leaves[nd.leaf]
            vals.append(leaf_fn(lf.kind, leaf_params[lf.slot], p,
                                lf.p0, lf.p1))
        elif nd.op == OP_UNION:
            vals.append(jnp.minimum(vals[nd.a], vals[nd.b]))
        elif nd.op == OP_INTERSECT:
            vals.append(jnp.maximum(vals[nd.a], vals[nd.b]))
        elif nd.op == OP_SUBTRACT:
            vals.append(jnp.maximum(vals[nd.a], -vals[nd.b]))
        elif nd.op == OP_SMOOTH_UNION:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(F32(0.5) + F32(0.5) * (b - a) / k)
            vals.append(mix(b, a, h) - k * h * (F32(1.0) - h))
        elif nd.op == OP_SMOOTH_INTERSECT:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(F32(0.5) - F32(0.5) * (b - a) / k)
            vals.append(mix(b, a, h) + k * h * (F32(1.0) - h))
        elif nd.op == OP_SMOOTH_SUBTRACT:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(F32(0.5) - F32(0.5) * (b + a) / k)
            vals.append(mix(a, -b, h) + k * h * (F32(1.0) - h))
        else:
            raise ValueError(f"unknown op {nd.op}")
    return vals[-1]


# ---------------------------------------------------------------------------
# Bounded sphere tracer — jnp twin of the Pallas kernel (component 6)
# ---------------------------------------------------------------------------

def _sphere_trace_impl(oir: ObjectIR, leaf_params, node_params, o, d,
                       t_min, t_max, max_steps: int, hit_eps: float,
                       eps_scale: float = 0.0):
    """Masked fixed-trip bounded march with batch-level early exit.

    Returns (t, hit_mask). Miss: t == BIG. The while_loop runs at most
    `max_steps` trips but exits as soon as every ray in the batch is done —
    the jnp analogue of the kernel's per-tile early exit
    [BASELINE.json:5 "lane-level early-exit"].
    """
    eps = F32(hit_eps)
    es = F32(eps_scale)
    t0 = jnp.full_like(o[0], t_min)
    done0 = jnp.zeros_like(o[0], dtype=bool)
    hit0 = jnp.zeros_like(o[0], dtype=bool)

    def cond(state):
        i, _, done, _ = state
        return (i < max_steps) & (~jnp.all(done))

    def body(state):
        i, t, done, hit = state
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = eval_sdf(oir, leaf_params, node_params, (px, py, pz))
        hit_now = h < (eps + es * t)
        over = t > t_max
        done_new = done | hit_now | over
        t_new = jnp.where(done_new, t, t + h)
        return i + 1, t_new, done_new, hit | (hit_now & (~done))

    _, t, _, hit = jax.lax.while_loop(cond, body, (0, t0, done0, hit0))
    t = jnp.where(hit, t, BIG)
    return t, hit


# ---------------------------------------------------------------------------
# Differentiable sphere trace: implicit-function-theorem adjoint
# (SURVEY.md §2 component 19, §3.3 hot loop #3; BASELINE.json:11
# "gradients through the raymarcher")
# ---------------------------------------------------------------------------
#
# The 256-step march defines t(θ, o, d) implicitly by f_θ(o + t·d) = 0 at the
# hit. Instead of unrolling/checkpointing the while_loop, the adjoint is the
# IFT at the hit point:   ∂t/∂θ = -(∂f/∂θ) / (∇f·d),
#                         ∂t/∂o = -∇f / (∇f·d),
#                         ∂t/∂d = -t·∇f / (∇f·d).
# Miss lanes get zero gradient. Non-differentiable at silhouettes (∇f·d → 0);
# the denominator is clamped — the standard, documented bias of inverse-SDF
# methods (SURVEY.md §7 hard part 4).

import functools as _functools
import os as _os

# IFT silhouette-denominator clamp (see _sphere_trace_bwd). On the c5
# pose probe at 1e-4 the clamp is inactive (no hit pixel has
# |∇f·d| < 1e-3), yet a handful of near-grazing lanes amplify
# FP-noise-limited contributions by up to 1/clamp, so two backends'
# gradients disagree; 1e-2 touches ~0.015% of hit pixels and removes
# that amplification, 1e-1 would touch ~1% — so 1e-2. The env override
# exists for sweeps of that trade.
_IFT_DENOM_CLAMP = float(_os.environ.get("SURFJAX_IFT_CLAMP", "1e-2"))


@_functools.partial(jax.custom_vjp, nondiff_argnums=(0, 5, 7, 8, 9))
def sphere_trace(oir: ObjectIR, leaf_params, node_params, o, d,
                 t_min, t_max, max_steps: int, hit_eps: float,
                 eps_scale: float = 0.0):
    return _sphere_trace_impl(oir, leaf_params, node_params, o, d,
                              t_min, t_max, max_steps, hit_eps, eps_scale)


def _sphere_trace_fwd(oir, leaf_params, node_params, o, d, t_min, t_max,
                      max_steps, hit_eps, eps_scale=0.0):
    t, hit = _sphere_trace_impl(oir, leaf_params, node_params, o, d,
                                t_min, t_max, max_steps, hit_eps, eps_scale)
    return (t, hit), (leaf_params, node_params, o, d, t, hit, t_max)


def _sphere_trace_bwd(oir, t_min, max_steps, hit_eps, eps_scale, res, cts):
    leaf_params, node_params, o, d, t, hit, t_max = res
    g_t, _g_hit = cts
    t_safe = jnp.where(hit, t, F32(0.0))
    p = (o[0] + t_safe * d[0], o[1] + t_safe * d[1], o[2] + t_safe * d[2])

    def f(lp, np_, px, py, pz):
        return eval_sdf(oir, lp, np_, (px, py, pz))

    _, vjp = jax.vjp(f, leaf_params, node_params, *p)
    ones = jnp.ones_like(t)
    _, _, gx, gy, gz = vjp(ones)
    denom = (gx * d[0] + gy * d[1]) + gz * d[2]
    # Clamp |denom| away from 0 (grazing silhouettes). The clamp floor is
    # the IFT's amplification bound: near-silhouette lanes scale g_t by up
    # to 1/clamp, so a too-small floor lets a handful of grazing pixels
    # dominate the image gradient with FP-noise-limited contributions
    # (see _IFT_DENOM_CLAMP).
    clamp = F32(_IFT_DENOM_CLAMP)
    denom = jnp.where(jnp.abs(denom) < clamp,
                      jnp.where(denom >= F32(0.0), clamp, -clamp),
                      denom)
    scale = jnp.where(hit, -g_t / denom, F32(0.0))
    g_lp, g_np, sgx, sgy, sgz = vjp(scale)
    g_o = (sgx, sgy, sgz)
    g_d = (t_safe * sgx, t_safe * sgy, t_safe * sgz)
    g_tmax = jnp.zeros_like(jnp.asarray(t_max, jnp.float32))
    return (g_lp, g_np, g_o, g_d, g_tmax)


sphere_trace.defvjp(_sphere_trace_fwd, _sphere_trace_bwd)


def normal_fd(oir: ObjectIR, leaf_params, node_params, p, eps: float):
    """4-tap tetrahedron finite-difference normal (component 8)."""
    e = F32(eps)
    # k0=(1,-1,-1) k1=(-1,-1,1) k2=(-1,1,-1) k3=(1,1,1)
    s0 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] + e, p[1] - e, p[2] - e))
    s1 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] - e, p[1] - e, p[2] + e))
    s2 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] - e, p[1] + e, p[2] - e))
    s3 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] + e, p[1] + e, p[2] + e))
    nx = ((s0 - s1) - s2) + s3
    ny = ((-s0 - s1) + s2) + s3
    nz = ((-s0 + s1) - s2) + s3
    return vnormalize((nx, ny, nz))


def soft_shadow_march(sdf_fn, o, d, t_min, t_max, k, steps: int):
    """Penumbra factor in [0,1] marching toward the light (component 12).

    sdf_fn(p) -> scene-level SDF (min over SDF objects; analytic objects are
    handled by the hard-occlusion path and multiplied in by the caller).
    Classic k*h/t penumbra accumulator. k may be a per-ray array
    (area lights: dist/radius).
    """
    kf = k if hasattr(k, "shape") else F32(k)
    t = jnp.full_like(o[0], t_min)
    res = jnp.ones_like(o[0])
    # a light nearer than t_min leaves no shadow segment: visibility 1,
    # never sample beyond the light (review r3 — matches the pallas
    # kernel and both goldens; previously one out-of-segment sample at
    # t_min could darken the pixel)
    done = t > t_max

    def cond(state):
        i, _, _, done = state
        return (i < steps) & (~jnp.all(done))

    def body(state):
        i, t, res, done = state
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = sdf_fn((px, py, pz))
        res_new = jnp.minimum(res, kf * h / t)
        # res-aware adaptive step (see kernels/_soft_march)
        s_allowed = (kf * h - res_new * t) / (kf + res_new)
        step = clamp(h, F32(1e-3), jnp.maximum(F32(0.5), s_allowed))
        t_new = t + step
        done_new = done | (res_new < F32(0.004)) | (t_new > t_max)
        res = jnp.where(done, res, res_new)
        t = jnp.where(done, t, t_new)
        return i + 1, t, res, done_new

    _, _, res, _ = jax.lax.while_loop(cond, body,
                                      (0, t, res, done))
    return saturate(res)


# Deterministic hemisphere probe directions (component 13): a small fixed fan
# around +z, rotated into the normal frame at run time. Host-side constants.
_AO_DIRS = (
    (0.0, 0.0, 1.0),
    (0.7, 0.0, 0.7141428),
    (-0.7, 0.0, 0.7141428),
    (0.0, 0.7, 0.7141428),
    (0.0, -0.7, 0.7141428),
    (0.5, 0.5, 0.7071068),
    (-0.5, 0.5, 0.7071068),
    (0.5, -0.5, 0.7071068),
    (-0.5, -0.5, 0.7071068),
)


def ao_probe_terms(sdf_fn, p, n, samples: int, radius: float):
    """Per-tap AO occlusion terms, in tap order (see ao_probes).

    Returned as a list of samples*4 arrays so callers can combine terms
    from several object groups BEFORE summing: per tap,
    max(az*r - min_j h_j, 0)/r == max_j (max(az*r - h_j, 0)/r) exactly
    (rounding is monotone and the subtraction/division preserve order),
    so a scene split into object groups can take the elementwise max of
    each group's tap terms and sum — bit-identical to evaluating the
    scene-min SDF. The pallas AO gate exploits this for value-exact
    per-object tile skips (kernels/render_tile.py::_ao_compute)."""
    samples = min(samples, len(_AO_DIRS))
    # orthonormal frame (t1, t2, n) — branch on |n.y| to avoid degeneracy
    big_y = jnp.abs(n[1]) > F32(0.9)
    hx = jnp.where(big_y, F32(1.0), F32(0.0))
    hy = jnp.where(big_y, F32(0.0), F32(1.0))
    # t1 = normalize(cross(h, n)); h = (hx, hy, 0)
    t1 = vnormalize((hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]))
    t2 = (n[1] * t1[2] - n[2] * t1[1],
          n[2] * t1[0] - n[0] * t1[2],
          n[0] * t1[1] - n[1] * t1[0])

    terms = []
    rad = F32(radius)
    for s in range(samples):
        ax, ay, az = _AO_DIRS[s]
        dx = (F32(ax) * t1[0] + F32(ay) * t2[0]) + F32(az) * n[0]
        dy = (F32(ax) * t1[1] + F32(ay) * t2[1]) + F32(az) * n[1]
        dz = (F32(ax) * t1[2] + F32(ay) * t2[2]) + F32(az) * n[2]
        for tap in range(1, 5):
            r = rad * F32(tap) * F32(0.25)
            h = sdf_fn((p[0] + dx * r, p[1] + dy * r, p[2] + dz * r))
            terms.append(jnp.maximum(F32(az) * r - h, F32(0.0)) / r)
    return terms


def ao_terms_to_factor(terms, samples: int, strength: float):
    """Tap terms -> ao factor, with ao_probes' exact accumulation order."""
    samples = min(samples, len(_AO_DIRS))
    occ = terms[0]
    for t in terms[1:]:
        occ = occ + t
    occ = occ / F32(samples * 4)
    return saturate(F32(1.0) - F32(strength) * occ)


def ao_probes(sdf_fn, p, n, samples: int, radius: float, strength: float):
    """Hemisphere ambient-occlusion probes (component 13).

    For each of `samples` fixed directions (rotated into the normal frame),
    take 4 taps at increasing radius; occlusion is how far the SDF falls
    short of the TANGENT-PLANE response cos(theta)*r (so the receiver's own
    plane contributes exactly zero — an isolated plane point reads the
    fully open hemisphere). Returns ao factor in [0, 1].
    """
    terms = ao_probe_terms(sdf_fn, p, n, samples, radius)
    return ao_terms_to_factor(terms, samples, strength)
