"""Fused Pallas kernels for the GPU (SURVEY.md §2 components 6 + 17, §1 L2).

BASELINE.json:5 — "pixel-tile ray generation, ray-surface intersection
(analytic quadric hits + bounded sphere-tracing for SDFs) as a masked
fixed-trip loop with lane-level early-exit, finite-difference/analytic
normal estimation ... fused into one framebuffer-resident pass. Secondary
rays (hard/soft shadows, AO probes) re-enter the same intersection kernel
batched."

Every kernel is a `pl.pallas_call` on the Triton route
(`backend="triton"`). One program handles one block of tile_rows x 128
rays, which is one TILE_H x TILE_W pixel patch of the image (see
tile_shape): each thread holds one ray or a few, ray state stays in
registers for the whole march, and a block leaves its while loops as
soon as its own rays are done, independently of every other block.

  K1 `render_tile_kernel` — the fused primary pass:
      analytic objects' exact hits (closed form, statically unrolled)
      -> bounded march of each SDF object, t_max clipped to the nearest
         hit so far, with per-block early exit
      -> normals: analytic (quadric/slab, with CSG orientation signs) or
         4-tap tetrahedron FD of the winning object's SDF
      -> AO hemisphere probes fused in (they re-enter the same SDF evals)

  K2 `trace_rays_kernel` — secondary-ray re-entry: batched shadow rays
      against the same scene (analytic any-hit + SDF march / penumbra
      accumulator) -> visibility factor per (hit, light).

  KF `frame_fused_kernel` — mesh-free frames and sequences in one call:
      ray generation from the program id, K1's trace, AO, K2's shadows
      and shading; no ray or G-buffer array round-trips device memory.

Scene parameters, cameras, lights, materials and crowd tables are small
global arrays that every block reads with scalar loads. Masks in while
loop carries are f32, and block-wide "all done" tests are float min/max
reductions (a boolean `any`/`all` reduction has no Triton lowering).

The jax.numpy twin of this exact algorithm is `scene_march_twin` below
(SURVEY.md §4.3 kernel/twin parity). On the CPU every kernel runs in the
Pallas interpreter, which is how the test suite exercises them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from surfjax.core.math import BIG, F32
from surfjax.core.scene_compile import (
    ENGINE_ANALYTIC, ENGINE_MESH, ENGINE_SDF, SceneWithMeshes,
)
from surfjax.core.types import FrameBuffers, RenderSettings
from surfjax.engines.analytic import intersect_analytic, object_normal_analytic
from surfjax.engines.sdf import eval_sdf
from surfjax.shade import shade_object


LANES = 128
# Pixel patch of one 128-ray row of a tile block: a block of tile_rows
# rows covers (TILE_H * tile_rows) x TILE_W pixels (see tile_shape).
TILE_W = 16


def _interpret() -> bool:
    """Pallas route for the default backend: the interpreter on the CPU
    (the test path), compiled Triton on the GPU. Any other platform is
    refused rather than silently interpreted."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"the pallas backend runs on 'gpu' (Triton) or 'cpu' (interpreted "
        f"for tests); the default JAX backend is {backend!r}")


def num_warps(tile_rows: int) -> int:
    """Warps per block: one ray per thread up to 8 warps (256 rays)."""
    return min(max(tile_rows * LANES // 32, 1), 8)


def _pallas(body, *, grid, in_specs, out_specs, out_shape, tile_rows: int):
    """pl.pallas_call on the Triton route with this module's launch
    shape (num_warps from the block size, no software pipelining: the
    kernels are loops over registers, not streams of loads)."""
    return pl.pallas_call(
        body, out_shape=out_shape, grid=grid, in_specs=in_specs,
        out_specs=out_specs, backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps(tile_rows), num_stages=1),
        interpret=_interpret())


def _read_params(lp_ref, np_ref, n_leaves: int, n_nodes: int):
    """Read scene parameter scalars into static structures that engines'
    code can index (python lists of scalar tuples)."""
    lp = [tuple(lp_ref[i, j] for j in range(8)) for i in range(n_leaves)]
    np_list = [[np_ref[i, 0]] for i in range(n_nodes)]

    class _Rows:
        def __init__(self, rows):
            self.rows = rows

        def __getitem__(self, idx):
            if isinstance(idx, tuple):
                return self.rows[idx[0]][idx[1]]
            return self.rows[idx]

    return _Rows(lp), _Rows(np_list)


def _mesh_params(params, mesh_idx):
    from surfjax.engines.mesh import _mesh_arrays
    return _mesh_arrays(params, mesh_idx)


def _split(static: SceneWithMeshes):
    ir = static.ir
    analytic = [(i, o) for i, o in enumerate(ir.objects)
                if o.engine == ENGINE_ANALYTIC]
    sdf = [(i, o) for i, o in enumerate(ir.objects)
           if o.engine == ENGINE_SDF]
    mesh = [(i, o) for i, o in enumerate(ir.objects)
            if o.engine == ENGINE_MESH]
    return analytic, sdf, mesh


def _scene_sdf(sdf_objs, lp, nparams, p, leaf_fn=None):
    from surfjax.engines.sdf import leaf_sdf_fast
    leaf_fn = leaf_fn or leaf_sdf_fast
    v = eval_sdf(sdf_objs[0][1], lp, nparams, p, leaf_fn=leaf_fn)
    for _, oir in sdf_objs[1:]:
        v = jnp.minimum(v, eval_sdf(oir, lp, nparams, p,
                                    leaf_fn=leaf_fn))
    return v


def _fast_leaf_fn(settings):
    """The kernel-path leaf evaluator for these settings: std or cheb
    bulb iteration (RenderSettings.bulb_iter) x hw or bitwise-portable
    epilogue log (RenderSettings.bulb_log)."""
    from surfjax.engines.sdf import make_leaf_fast
    return make_leaf_fast(settings.bulb_iter, settings.bulb_log)


def _capped_leaf_fn(cap: int, settings=None):
    """Leaf evaluator with fractal DEs iteration-capped at `cap`.
    The truncated prisoner set is a superset of the full one, so the
    capped DE lower-bounds distance to a surface enclosing the true one."""
    from surfjax.core.scene_compile import LEAF_MANDELBULB
    from surfjax.engines.sdf import leaf_sdf, make_bulb_while
    bulb = make_bulb_while(
        settings.bulb_iter if settings is not None else "std",
        settings.bulb_log if settings is not None else "hw")

    def leaf_fn(kind, prm, p, p0=0, p1=0):
        if kind == LEAF_MANDELBULB:
            return bulb(prm, p, p0, min(p1, cap))
        return leaf_sdf(kind, prm, p, p0, p1)

    return leaf_fn


def _lod_leaf_fn(settings):
    """Secondary-ray leaf evaluator: fractal DEs iteration-capped by
    settings.secondary_lod_iters (see RenderSettings). None = full."""
    cap = settings.secondary_lod_iters
    if not cap:
        return None
    return _capped_leaf_fn(cap, settings)


# ---------------------------------------------------------------------------
# Proxy (lower-bound) scene SDF for the two-phase march.
#
# For each SDF object that contains only bounded leaves (sphere/box/
# mandelbulb), a single bounding sphere is derived from its leaf scalars:
# sdf_bound(p) = |p-c| - R <= sdf_object(p) everywhere outside. Cheap objects
# (<= 2 nodes) and unboundable ones (plane leaves) contribute their exact
# SDF. The proxy is therefore a pointwise LOWER bound of the scene SDF, so
# marching it can never overshoot a true surface — phase 1 is sound.
# ---------------------------------------------------------------------------

_BOUNDED_KINDS = None  # set lazily to avoid import cycle

# Bulb bounding-radius factors (canonical units, x leaf scale). TWO
# constants because the two gating families need DIFFERENT properties:
#
#   COVER (march entry/exit, hard-shadow segment skip): the hit region
#   {DE_it < e} must lie inside the sphere for every runtime eps e and
#   iteration count. Validated: {DE_8 < 0.05} has max radius ~1.25
#   (tools/gen_lobe_bounds.py grid; truncated DEs only shrink it... the
#   truncated sets are FATTER but still within 1.25 — checked in
#   tests/test_engines.py::test_bulb_bound_constants).
#
#   LOWER (soft-shadow influence windows, AO far gate, proxy SDF): the
#   sphere SDF must lower-bound the DE POINTWISE (h_bound <= DE
#   everywhere), because those gates skip samples wherever
#   k*h_bound/t >= 1 / bound-dist >= radius. MEASURED (16M random
#   samples to radius 8, iters {2,4,8}): max(|p| - DE) = 1.3607 at
#   r0 ~ 2.70 — the raw DE underestimates distance most in that shell,
#   so the old shared 1.3 factor violated the property by up to
#   0.06*scale there (soft-shadow window edges read ~0.07 too light vs
#   the golden). 1.39 restores it with margin.
BULB_BOUND_COVER = 1.3
BULB_BOUND_LOWER = 1.39


def _leaf_bound_scalars(lf, lp, lower: bool = False,
                        cover_margin: float | None = None):
    """(cx, cy, cz, radius) scalars for one bounded leaf. lower=True
    returns a sphere whose SDF pointwise lower-bounds the leaf SDF
    (see BULB_BOUND_LOWER); lower=False a hit-region cover.

    cover_margin (cover mode only): the worst-case hit epsilon the caller
    will gate against. The 1.3 bulb COVER is validated to contain
    {DE < eps} only for eps <= 0.045*scale (test_bulb_bound_constants);
    outside that regime the radius falls back (traced, per-leaf — robust
    against fit loops perturbing scale) to the pointwise LOWER bound
    inflated by the margin, which covers {DE < m} for ANY m
    (h_lower <= DE  =>  DE < m  =>  |p-c| < R_lower + m).
    Advisor r3: the shadow segment skip applied the 1.3 cover
    unconditionally, silently under-occluding at hit_eps_scale*t_max
    beyond ~0.045*scale."""
    from surfjax.core.scene_compile import (
        LEAF_BOX, LEAF_MANDELBULB, LEAF_SPHERE,
    )
    prm = lp[lf.slot]
    if lf.kind == LEAF_SPHERE:
        return prm[0], prm[1], prm[2], prm[3]
    if lf.kind == LEAF_BOX:
        r = jnp.sqrt((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5])
        return prm[0], prm[1], prm[2], r
    if lf.kind == LEAF_MANDELBULB:
        if lf.p0 != 8:
            return None  # the bound factors are validated for power 8
        if lower:
            return prm[0], prm[1], prm[2], prm[3] * F32(BULB_BOUND_LOWER)
        r_cover = prm[3] * F32(BULB_BOUND_COVER)
        if cover_margin is not None:
            r_safe = prm[3] * F32(BULB_BOUND_LOWER) + F32(cover_margin)
            r_cover = jnp.where(
                F32(cover_margin) <= F32(0.045) * prm[3], r_cover, r_safe)
        return prm[0], prm[1], prm[2], r_cover
    return None


def _object_bound(oir, lp, nparams, lower: bool = False,
                  cover_margin: float | None = None):
    """Bounding sphere scalars of one SDF object, or None if unboundable.

    Smooth unions can push the surface outward by at most k/4 (polynomial
    smin >= min - k/4); that margin is added. `lower` selects the
    pointwise-lower-bound radius for iterated-DE leaves (see
    _leaf_bound_scalars) — callers gating on h_bound <= sdf everywhere
    (influence windows, AO far gate, proxy march) MUST pass lower=True.
    Callers gating hit registration against a cover (segment skips,
    entry/exit clips) MUST pass their worst-case hit epsilon as
    cover_margin so iterated-DE covers stay valid at large epsilons.
    """
    from surfjax.core.scene_compile import LEAF_PLANE
    if any(lf.kind == LEAF_PLANE for lf in oir.leaves):
        return None
    bounds = [_leaf_bound_scalars(lf, lp, lower=lower,
                                  cover_margin=cover_margin)
              for lf in oir.leaves]
    if any(b is None for b in bounds):
        return None
    n = float(len(bounds))
    cx = sum(b[0] for b in bounds) * F32(1.0 / n)
    cy = sum(b[1] for b in bounds) * F32(1.0 / n)
    cz = sum(b[2] for b in bounds) * F32(1.0 / n)
    R = None
    for bx, by, bz, br in bounds:
        dx, dy, dz = bx - cx, by - cy, bz - cz
        rr = jnp.sqrt((dx * dx + dy * dy) + dz * dz) + br
        R = rr if R is None else jnp.maximum(R, rr)
    k_margin = F32(0.0)
    for nd in oir.nodes:
        if nd.pslot >= 0:
            k_margin = k_margin + nparams[nd.pslot, 0] * F32(0.25)
    return cx, cy, cz, R + k_margin


def _proxy_sdf_fn(sdf_objs, lp, nparams):
    """-> (proxy_fn or None). None means no object benefits from a proxy."""
    from surfjax.core.scene_compile import LEAF_MANDELBULB
    parts = []
    any_bounded_expensive = False
    for _, oir in sdf_objs:
        # a node-count-cheap object still deserves a proxy if its leaf is
        # an iterated fractal DE (the single-leaf Mandelbulb: ~8x the
        # eval cost of its bounding sphere, and the tile-level inner-loop
        # escape check makes near-tile far-lane evals pay full price)
        has_fractal = any(lf.kind == LEAF_MANDELBULB for lf in oir.leaves)
        cheap = len(oir.nodes) <= 2 and not has_fractal
        b = None if cheap else _object_bound(oir, lp, nparams,
                                             lower=True)
        if b is None:
            parts.append(("exact", oir))
        else:
            parts.append(("bound", b))
            any_bounded_expensive = True
    if not any_bounded_expensive:
        return None

    def proxy(p):
        v = None
        for kind, payload in parts:
            if kind == "exact":
                h = eval_sdf(payload, lp, nparams, p)
            else:
                cx, cy, cz, R = payload
                dx = p[0] - cx
                dy = p[1] - cy
                dz = p[2] - cz
                h = jnp.sqrt((dx * dx + dy * dy) + dz * dz) - R
            v = h if v is None else jnp.minimum(v, h)
        return v

    return proxy


def _march(sdf_fn, o, d, t_start, t_clip, max_steps: int, hit_eps: float,
           t_init=None, relax: float = 1.0, eps_scale: float = 0.0,
           park=None):
    """Bounded scene march with per-block early exit. f32 mask carries.

    Returns (t, hit_f): hit_f is a 0/1 f32 hit mask. Lanes whose t_clip
    is already below t_start skip the march entirely (done at trip 0).
    t_init overrides the per-lane starting t (two-phase handoff).

    relax > 1 enables over-relaxed sphere tracing (Keinert et al. style):
    step by relax*h; if the relaxed step is detected to have skipped past
    non-overlapping safety spheres (st_prev > h_prev + |h|), retreat to the
    conservative point and continue unrelaxed for one step — no surface can
    be missed.

    park: optional (x, y, z) scalars — DONE lanes evaluate the SDF at
    this fixed far point instead of their frozen hit/clip position. A
    done lane's h flows into nothing (hit/done/t/h_prev/st_prev are all
    frozen by the done mask), so this is bitwise value-exact — but for
    iterated-DE leaves (Mandelbulb) it is the difference between the
    lane-escaping while-DE running 0 iterations vs the FULL count every
    remaining trip: a lane parked AT its hit point sits on the prisoner
    set and never escapes, pinning the whole tile's DE loop at max
    iterations for the rest of the march (asserted bitwise in
    tests/test_kernels.py::test_park_point_value_exact).
    """
    eps = F32(hit_eps)
    w = F32(relax)
    t0 = (t_start * jnp.ones_like(o[0])) if t_init is None else t_init
    done0 = jnp.where(t0 >= t_clip, F32(1.0), F32(0.0))
    hit0 = jnp.zeros_like(o[0])
    z0 = jnp.zeros_like(o[0])

    def cond(s):
        i, _, _, _, done, _ = s
        return (i < max_steps) & (jnp.min(done) < F32(0.5))

    def substep(t, h_prev, st_prev, done, hit):
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        if park is not None:
            parked = done > F32(0.5)
            px = jnp.where(parked, park[0], px)
            py = jnp.where(parked, park[1], py)
            pz = jnp.where(parked, park[2], pz)
        h = sdf_fn((px, py, pz))
        if relax > 1.0:
            ovr = jnp.where(st_prev > h_prev + jnp.abs(h),
                            F32(1.0), F32(0.0))
        else:
            ovr = z0
        ok = F32(1.0) - ovr
        eps_eff = eps + F32(eps_scale) * t
        hit_now = ok * jnp.where(h < eps_eff, F32(1.0), F32(0.0))
        over = ok * jnp.where(t > t_clip, F32(1.0), F32(0.0))
        active = F32(1.0) - done
        hit = jnp.maximum(hit, hit_now * active)
        done_new = jnp.maximum(done, jnp.maximum(hit_now, over))
        step = w * h
        t_fwd = t + step
        t_retreat = (t - st_prev) + h_prev  # unrelaxed fallback point
        t_next = jnp.where(ovr > F32(0.5), t_retreat, t_fwd)
        t = jnp.where(done_new > F32(0.5), t, t_next)
        # freeze the overshoot-test state for finished lanes
        h_prev = jnp.where(done_new > F32(0.5), h_prev, ok * h)
        st_prev = jnp.where(done_new > F32(0.5), st_prev, ok * step)
        return t, h_prev, st_prev, done_new, hit

    # largest unroll dividing the budget keeps the step count exact
    unroll = next(u for u in range(min(MARCH_UNROLL, max_steps), 0, -1)
                  if max_steps % u == 0)

    def body(s):
        i, t, h_prev, st_prev, done, hit = s
        # unrolled substeps per while trip: divides the per-trip loop
        # and all-done-reduction overhead (worst case wastes
        # unroll-1 evals per tile)
        for _ in range(unroll):
            t, h_prev, st_prev, done, hit = substep(t, h_prev, st_prev,
                                                    done, hit)
        return i + unroll, t, h_prev, st_prev, done, hit

    _, t, _, _, _, hit = jax.lax.while_loop(
        cond, body, (0, t0, z0, z0, done0, hit0))
    return t, hit


_PROXY_SWITCH = 0.08  # hand off to the full SDF within this proxy distance
# March substeps per while trip. Unrolled substeps are value-exact (done
# lanes masked; the divisor logic keeps step budgets exact); they trade
# code size and registers for fewer block-wide "all done" reductions.
# Not yet swept on the GPU (PERF.md, open questions).
MARCH_UNROLL = 2        # full-SDF march substeps per trip
SOFT_MARCH_UNROLL = 2   # penumbra-march substeps per trip


def _bulb_entry_shell(oir, lp, exit_margin: float):
    """Thin entry-shell scalar for a single-leaf power-8 Mandelbulb, or
    None to keep _bound_entry's default max(_PROXY_SWITCH, exit_margin).

    The default 0.08 shell exists because a generic bound sphere hugs
    the surface (sphere/box leaves), so the entry must clear every
    possible eps_eff AND leave the first march step useful. The bulb's
    COVER bound (BULB_BOUND_COVER = 1.3) is validated to contain the
    whole hit region {DE_it < 0.05*scale} (test_bulb_bound_constants),
    so entering at radius 1.3*scale + exit_margin is already sound —
    the 0.08 inflation only admits a useless silhouette ring of rays
    whose march starts ~0.08 further out.

    Static gates: single positive bulb leaf, power 8, iterations in
    the validated set {2,4,8}. Dynamic gate (traced — robust against a
    fit loop perturbing leaf params): bailout == 2.0 and
    exit_margin <= 0.045*scale (the validated cover threshold with
    margin); invalid lanes fall back to the default shell."""
    from surfjax.core.scene_compile import LEAF_MANDELBULB
    if len(oir.nodes) != 1:
        return None
    lf = oir.leaves[0]
    if (lf.kind != LEAF_MANDELBULB or lf.sign <= 0 or lf.p0 != 8
            or lf.p1 not in (2, 4, 8)):
        return None
    prm = lp[lf.slot]
    valid = (jnp.abs(prm[4] - F32(2.0)) < F32(1e-6)) & \
        (F32(exit_margin) <= F32(0.045) * prm[3])
    return jnp.where(valid, F32(exit_margin),
                     F32(max(_PROXY_SWITCH, exit_margin)))


def _park_point(oir, lp):
    """Far evaluation point for DONE lanes of a march over this object
    (see _march's `park`), or None when the object has no iterated-DE
    leaf (parking only pays for while-loop DEs).

    The point must escape EVERY Mandelbulb leaf's iteration at trip 0:
    m0 > bailout2 = 16*bailout^2, i.e. canonical radius > 4*bailout.
    p = (max_i(cx_i + s_i*(4*b_i + 2)), 0, 0) gives per-leaf
    |p - c_i| >= px - cx_i >= s_i*(4*b_i + 2), so canonical radius
    >= 4*b_i + 2 > 4*b_i for every bulb leaf i."""
    from surfjax.core.scene_compile import LEAF_MANDELBULB
    px = None
    for lf in oir.leaves:
        if lf.kind != LEAF_MANDELBULB:
            continue
        prm = lp[lf.slot]
        cand = prm[0] + prm[3] * (F32(4.0) * prm[4] + F32(2.0))
        px = cand if px is None else jnp.maximum(px, cand)
    if px is None:
        return None
    return (px, F32(0.0), F32(0.0))


def _scene_park_point(sdf_objs, lp):
    """Scene-level far park point: escapes every Mandelbulb leaf of every
    SDF object at iteration 0 (componentwise max of the per-object
    constructions in _park_point), or None if no object needs parking."""
    px = None
    for _, oir in sdf_objs:
        p = _park_point(oir, lp)
        if p is None:
            continue
        px = p[0] if px is None else jnp.maximum(px, p[0])
    if px is None:
        return None
    return (px, F32(0.0), F32(0.0))


def _bound_entry(b, o, d, t_start, t_clip, exit_margin: float,
                 shell=None):
    """Closed-form replacement for marching a single-sphere proxy.

    b = (cx, cy, cz, R) object bounding sphere. The sphere is inflated
    by max(_PROXY_SWITCH, exit_margin): outside it the object SDF
    exceeds both the proxy handoff distance and every possible hit
    epsilon (the caller passes exit_margin >= hit_eps + eps_scale *
    t_max), so entering at its boundary is exactly the iterative proxy
    march's handoff — without its ~6-step while loop — and clipping at
    its exit is value-exact (no hit can register beyond). One radius
    serves both: using a thinner entry shell would be unsound for
    configs whose eps_eff exceeds _PROXY_SWITCH, where an eps-fat hit
    could exist outside the thin shell. Returns (t1, clip2); rays that
    miss the inflated bound (or whose intersection lies behind t_start)
    get t1 = clip2 = t_clip, so the march's done0 fires immediately.

    shell: optional per-call override of the inflation (scalar, may be
    traced). Callers may pass a thinner shell ONLY when the bound is a
    validated hit-region cover at a threshold >= every possible
    eps_eff — see _bulb_entry_shell."""
    cx, cy, cz, R = b
    Re = R + (F32(max(_PROXY_SWITCH, exit_margin)) if shell is None
              else shell)
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    pb = (wx * d[0] + wy * d[1]) + wz * d[2]
    w2 = (wx * wx + wy * wy) + wz * wz
    disc = pb * pb - (w2 - Re * Re)
    sq = jnp.sqrt(jnp.maximum(disc, F32(0.0)))
    t_in = pb - sq
    t_out = pb + sq
    none = (disc < F32(0.0)) | (t_out <= t_start)
    t1 = jnp.maximum(t_in, t_start)
    t1 = jnp.where(none, t_clip, t1)
    clip2 = jnp.where(none, t_clip, jnp.minimum(t_clip, t_out))
    return t1, clip2


def _fd_normal(sdf_fn, p, eps: float):
    e = F32(eps)
    s0 = sdf_fn((p[0] + e, p[1] - e, p[2] - e))
    s1 = sdf_fn((p[0] - e, p[1] - e, p[2] + e))
    s2 = sdf_fn((p[0] - e, p[1] + e, p[2] - e))
    s3 = sdf_fn((p[0] + e, p[1] + e, p[2] + e))
    nx = ((s0 - s1) - s2) + s3
    ny = ((-s0 - s1) + s2) + s3
    nz = ((-s0 + s1) - s2) + s3
    inv = F32(1.0) / jnp.sqrt((nx * nx + ny * ny) + nz * nz)
    return (nx * inv, ny * inv, nz * inv)


# ---------------------------------------------------------------------------
# Vectorized object loop ("crowd") for large scenes — r3 verdict Weak #4.
#
# The per-object static unrolling above traces and compiles every object
# anew, which caps practical scene size. With RenderSettings.
# vector_objects, single-leaf positively-signed sphere/box SDF objects
# become a "crowd": ONE lax.fori_loop whose body reads member
# parameters by dynamic scalar index (cm meta rows +
# leaf_params rows) and runs the IDENTICAL per-member arithmetic as the
# unrolled path (_bound_entry + _march; per-member FD normals; per-member
# shadow marches / closed-form sphere penumbrae; gated AO terms; material
# gather + per-shininess-group shading). Per-lane results are therefore
# bitwise-equal to the unrolled path on crowd-only scenes (the merge ops
# — where/min/max — are per-member independent), asserted in
# tests/test_crowd.py. Members are ordered spheres-first so each loop
# section is statically single-kind (no per-step kind selects).
# ---------------------------------------------------------------------------

class CrowdIR(NamedTuple):
    """Crowd membership, partitioned into statically-kinded sections so
    every fori_loop body is single-kind/single-engine: members =
    sdf spheres ++ sdf boxes ++ analytic spheres ++ analytic boxes ++
    two-leaf SDF pairs grouped by (leaf kinds, op) (scene order within
    each section). Pair sections (r5, verdict Next #4): objects whose
    tape is exactly op(leaf0, leaf1) with op in {union, smooth_union}
    and both leaves positive sphere/box — the repeated-structure CSG
    class whose unrolled compile grows with every object."""
    members: Tuple      # ((obj_idx, ObjectIR), ...) in section order
    n_sph_sdf: int
    n_box_sdf: int
    n_sph_ana: int
    n_box_ana: int
    shin_groups: Tuple  # distinct static shininess values (group order)
    # ((is_sphere0, is_sphere1, op, count), ...) — static pair sections,
    # in canonical (kinds, op) order; members for section i follow the
    # four single sections contiguously
    pair_specs: Tuple = ()

    @property
    def sdf_ranges(self):
        a = self.n_sph_sdf
        return ((0, a, True), (a, a + self.n_box_sdf, False))

    @property
    def ana_ranges(self):
        s = self.n_sph_sdf + self.n_box_sdf
        a = s + self.n_sph_ana
        return ((s, a, True), (a, a + self.n_box_ana, False))

    @property
    def all_ranges(self):
        return self.sdf_ranges + self.ana_ranges

    @property
    def n_singles(self):
        return (self.n_sph_sdf + self.n_box_sdf + self.n_sph_ana
                + self.n_box_ana)

    @property
    def pair_ranges(self):
        """((lo, hi, (is_s0, is_s1, op)), ...) — same shape contract as
        sdf_ranges/ana_ranges so _crowd_sections runs them unchanged
        (the static tag is the pair spec instead of is_sphere)."""
        out = []
        lo = self.n_singles
        for is_s0, is_s1, op, cnt in self.pair_specs:
            out.append((lo, lo + cnt, (is_s0, is_s1, op)))
            lo += cnt
        return tuple(out)

    @property
    def gather_ranges(self):
        """Every member (the shade/material gather ignores the tag)."""
        return self.all_ranges + self.pair_ranges

    @property
    def has_sdf(self):
        return self.n_sph_sdf + self.n_box_sdf > 0 or bool(self.pair_specs)

    @property
    def has_ana(self):
        return self.n_sph_ana + self.n_box_ana > 0


def split_crowd(static, settings):
    """-> (CrowdIR | None, rest_analytic, rest_sdf) — each rest a
    [(i, oir), ...] of that engine's non-crowd objects.

    Crowd-eligible: single positive sphere/box leaf on the SDF OR the
    analytic engine, plus (r5) SDF two-leaf PAIRS — tape exactly
    op(leaf0, leaf1) for ANY of the six binary CSG ops (union/
    intersect/subtract and their smooth forms), both leaves positive
    sphere/box (planes, bulbs, deeper CSG tapes, analytic pairs, meshes
    stay unrolled). The crowd forms only with vector_objects on and
    >= 2 eligible members (below that the unrolled path compiles fast
    and identically)."""
    from surfjax.api import OP_LEAF
    from surfjax.core.scene_compile import LEAF_BOX, LEAF_SPHERE
    analytic, sdf_objs, _ = _split(static)
    if not settings.vector_objects:
        return None, analytic, sdf_objs

    def eligible(oir):
        lf = oir.leaves[0] if len(oir.leaves) == 1 else None
        return (len(oir.nodes) == 1 and lf is not None and lf.sign > 0
                and lf.kind in (LEAF_SPHERE, LEAF_BOX))

    def pair_spec(oir):
        """(is_s0, is_s1, op) when the object is an eligible SDF pair,
        else None."""
        if len(oir.nodes) != 3 or len(oir.leaves) != 2:
            return None
        from surfjax.api import OP_SMOOTH_SUBTRACT, OP_SUBTRACT
        n0, n1, n2 = oir.nodes
        if not (n0.op == OP_LEAF and n1.op == OP_LEAF
                and n2.op != OP_LEAF and n2.a == 0 and n2.b == 1):
            return None
        l0, l1 = oir.leaves
        for lf in (l0, l1):
            if lf.kind not in (LEAF_SPHERE, LEAF_BOX):
                return None
        # leaf signs are orientation parity from scene_compile's walk():
        # +1 everywhere except the subtracted operand (-1). eval_sdf
        # negates the subtract operand explicitly (the sign field only
        # orients ANALYTIC normals, unused on the SDF/FD path), so the
        # op-implied parity is the eligible shape; anything else is an
        # unexpected tape — stay unrolled.
        sub = n2.op in (OP_SUBTRACT, OP_SMOOTH_SUBTRACT)
        if l0.sign <= 0 or (l1.sign > 0) == sub:
            return None
        return (l0.kind == LEAF_SPHERE, l1.kind == LEAF_SPHERE, n2.op)

    def pick(objs, allow_pairs):
        members = [(i, o) for i, o in objs if eligible(o)]
        pairs = ([(i, o) for i, o in objs
                  if not eligible(o) and pair_spec(o) is not None]
                 if allow_pairs else [])
        taken = {i for i, _ in members} | {i for i, _ in pairs}
        rest = [(i, o) for i, o in objs if i not in taken]
        sph = [m for m in members if m[1].leaves[0].kind == LEAF_SPHERE]
        box = [m for m in members if m[1].leaves[0].kind == LEAF_BOX]
        return sph, box, pairs, rest

    sph_s, box_s, pairs_s, rest_sdf = pick(sdf_objs, True)
    sph_a, box_a, _, rest_ana = pick(analytic, False)

    # group pairs by static (kinds, op) spec, canonical order
    spec_order = []
    by_spec = {}
    for m in pairs_s:
        sp = pair_spec(m[1])
        if sp not in by_spec:
            spec_order.append(sp)
            by_spec[sp] = []
        by_spec[sp].append(m)
    pair_members = [m for sp in spec_order for m in by_spec[sp]]
    pair_specs = tuple((sp[0], sp[1], sp[2], len(by_spec[sp]))
                       for sp in spec_order)

    members = sph_s + box_s + sph_a + box_a + pair_members
    if len(members) < 2:
        return None, analytic, sdf_objs
    groups = []
    for _, oir in members:
        if oir.shininess not in groups:
            groups.append(oir.shininess)
    return (CrowdIR(tuple(members), len(sph_s), len(box_s), len(sph_a),
                    len(box_a), tuple(groups), pair_specs),
            rest_ana, rest_sdf)


@functools.lru_cache(maxsize=64)
def _crowd_meta_cached(static, settings):
    crowd, _, _ = split_crowd(static, settings)
    if crowd is None:
        return np.zeros((1, 6), np.int32)
    rows = []
    for i, oir in crowd.members:
        slot1 = oir.leaves[1].slot if len(oir.leaves) == 2 else 0
        pslot = (max(oir.nodes[-1].pslot, 0) if len(oir.nodes) == 3
                 else 0)
        rows.append([oir.leaves[0].slot, i, oir.mat,
                     crowd.shin_groups.index(oir.shininess), slot1, pslot])
    return np.asarray(rows, np.int32)


def crowd_meta(static, settings):
    """(max(1,n), 6) int32 [leaf_slot0, obj_idx, mat_idx, shin_group,
    leaf_slot1, node_pslot] — the side table every kernel body
    receives (row j = member j, singles first, then pair sections).
    slot1/pslot are 0 for single-leaf members (never read: sections are
    statically kinded). A (1,6) zero row stands in when there is no
    crowd."""
    return jnp.asarray(_crowd_meta_cached(static, settings))


def _crowd_member(crowd_refs, j):
    """Member j's (leaf params 8-tuple, obj idx f32, mat idx, group f32),
    all via dynamic scalar reads (kernel refs in kernels, jnp arrays in
    the twin)."""
    cm, lpr, _ = crowd_refs
    slot = cm[j, 0]
    prm = tuple(lpr[slot, k] for k in range(8))
    return (prm, cm[j, 1].astype(jnp.float32), cm[j, 2],
            cm[j, 3].astype(jnp.float32))


def _crowd_member_pair(crowd_refs, j):
    """Pair member j's (prm0, prm1, k, obj idx f32, mat idx, group f32).
    k is the smooth-op blend radius (node_params[pslot, 0]; read but
    unused for hard-union sections — their formula never touches it)."""
    cm, lpr, npr = crowd_refs
    slot0 = cm[j, 0]
    slot1 = cm[j, 4]
    prm0 = tuple(lpr[slot0, k] for k in range(8))
    prm1 = tuple(lpr[slot1, k] for k in range(8))
    k = npr[cm[j, 5], 0]
    return (prm0, prm1, k, cm[j, 1].astype(jnp.float32), cm[j, 2],
            cm[j, 3].astype(jnp.float32))


def _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k):
    """Pair member SDF op(leaf0, leaf1) — the EXACT arithmetic and
    association of engines.sdf.eval_sdf's tape for this 3-node object,
    so pair-crowd geometry stays bitwise-equal to the unrolled path.
    All six binary CSG ops (r5; hard ops never read k)."""
    from surfjax.api import (OP_INTERSECT, OP_SMOOTH_INTERSECT,
                             OP_SMOOTH_SUBTRACT, OP_SMOOTH_UNION,
                             OP_SUBTRACT, OP_UNION)
    from surfjax.core.math import mix, saturate
    f0 = _crowd_leaf_sdf(prm0, is_s0)
    f1 = _crowd_leaf_sdf(prm1, is_s1)
    if op == OP_UNION:
        return lambda p: jnp.minimum(f0(p), f1(p))
    if op == OP_INTERSECT:
        return lambda p: jnp.maximum(f0(p), f1(p))
    if op == OP_SUBTRACT:
        return lambda p: jnp.maximum(f0(p), -f1(p))

    def f(p):  # smooth ops (Quilez polynomial forms, as eval_sdf)
        a = f0(p)
        b = f1(p)
        if op == OP_SMOOTH_UNION:
            h = saturate(F32(0.5) + F32(0.5) * (b - a) / k)
            return mix(b, a, h) - k * h * (F32(1.0) - h)
        if op == OP_SMOOTH_INTERSECT:
            h = saturate(F32(0.5) - F32(0.5) * (b - a) / k)
            return mix(b, a, h) + k * h * (F32(1.0) - h)
        # OP_SMOOTH_SUBTRACT
        h = saturate(F32(0.5) - F32(0.5) * (b + a) / k)
        return mix(a, -b, h) + k * h * (F32(1.0) - h)
    return f


def _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k):
    """Pair bounding sphere — the EXACT arithmetic of _object_bound for
    a two-leaf tape (mean center; max leaf reach; + k/4 margin for any
    smooth op = the pslot >= 0 filter), so bound entries/clips match
    the unrolled path bitwise. Both bound properties hold for all six
    ops: COVER — every op's surface lies inside the union of the two
    leaf solids' closures, which the ball contains (R reaches past both
    leaf balls); POINTWISE LOWER BOUND — union = min(a,b) >= the ball's
    SDF (the ball contains both leaf balls), intersect/subtract
    max(a,+-b) >= a >= ball, smooth_union >= min - k/4, smooth_intersect
    >= max >= a, and smooth_subtract(a,b) >= a (the blend-band excess
    is exactly k*h^2 >= 0, endpoints a and -b >= a+k); the k/4 margin
    only loosens the last three further."""
    from surfjax.api import _SMOOTH_OPS
    b0 = _crowd_bound(prm0, is_s0)
    b1 = _crowd_bound(prm1, is_s1)
    cx = (b0[0] + b1[0]) * F32(0.5)
    cy = (b0[1] + b1[1]) * F32(0.5)
    cz = (b0[2] + b1[2]) * F32(0.5)
    R = None
    for bx, by, bz, br in (b0, b1):
        dx, dy, dz = bx - cx, by - cy, bz - cz
        rr = jnp.sqrt((dx * dx + dy * dy) + dz * dz) + br
        R = rr if R is None else jnp.maximum(R, rr)
    if op in _SMOOTH_OPS:
        # _object_bound: k_margin = F32(0.0) + k * F32(0.25); the
        # leading exact zero is a no-op on normal k
        R = R + k * F32(0.25)
    return cx, cy, cz, R


def _crowd_bound(prm, is_sphere: bool):
    """Member bounding sphere — for sphere/box leaves the cover and the
    pointwise lower bound coincide (same formulas as _leaf_bound_scalars)."""
    if is_sphere:
        return (prm[0], prm[1], prm[2], prm[3])
    r = jnp.sqrt((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5])
    return (prm[0], prm[1], prm[2], r)


def _crowd_leaf_sdf(prm, is_sphere: bool):
    from surfjax.engines.sdf import sdf_box, sdf_sphere
    if is_sphere:
        return lambda p: sdf_sphere(prm, p)
    return lambda p: sdf_box(prm, p)


def _crowd_sections(ranges, fn, carry):
    """Run fn(j, is_sphere, carry) over the given member index ranges
    ((lo, hi, is_sphere), ...) — one statically-kinded fori_loop per
    non-empty range (see CrowdIR.sdf_ranges/ana_ranges/all_ranges)."""
    for lo, hi, is_sphere in ranges:
        if hi > lo:
            carry = jax.lax.fori_loop(
                lo, hi, lambda j, c, k=is_sphere: fn(j, k, c), carry)
    return carry


def _leaf_exact_t(prm, is_sphere: bool, o, d, t_min, t_max):
    """Nearest boundary t of a single positive sphere/box leaf in
    (t_min, t_max) — the exact same interval arithmetic as
    intersect_analytic's single-leaf fast path (engines/analytic.py),
    with the member's params read dynamically. Miss: BIG."""
    from surfjax.core.scene_compile import LEAF_BOX, LEAF_SPHERE
    from surfjax.engines.analytic import leaf_interval
    kind = LEAF_SPHERE if is_sphere else LEAF_BOX
    t0, t1 = leaf_interval(kind, prm, o, d)
    e0 = (t0 > t_min) & (t0 < t_max)
    e1 = (t1 > t_min) & (t1 < t_max)
    return jnp.where(e0, t0, jnp.where(e1, t1, BIG))


def _crowd_analytic_trace(crowd, crowd_refs, o, d, t_min, t_max, state):
    """Crowd section of the analytic primary pass: exact per-member
    nearest hits merged like the unrolled analytic loop.
    state/-> (t_a, obj, leaf)."""
    def member(j, is_sphere, carry):
        t_a, obj, leaf = carry
        prm, obj_f, _, _ = _crowd_member(crowd_refs, j)
        t_j = _leaf_exact_t(prm, is_sphere, o, d, t_min, t_max)
        better = t_j < t_a
        t_a = jnp.where(better, t_j, t_a)
        obj = jnp.where(better, obj_f, obj)
        leaf = jnp.where(better, F32(0.0), leaf)
        return (t_a, obj, leaf)

    return _crowd_sections(crowd.ana_ranges, member, state)


def _crowd_trace(crowd, crowd_refs, o, d, t_start, settings,
                 steps: int, exit_margin: float, state):
    """Crowd section of trace_core: per-member bound entry + march with
    progressive clipping, merged exactly like the unrolled loop.
    state/-> (t, obj, leaf, t_clip)."""
    def merge(carry, t_j, hit_j, obj_f):
        t, obj, leaf, t_clip = carry
        better = (hit_j > F32(0.5)) & (t_j < t)
        t = jnp.where(better, t_j, t)
        obj = jnp.where(better, obj_f, obj)
        leaf = jnp.where(better, F32(0.0), leaf)
        t_clip = jnp.minimum(t_clip, t)
        return (t, obj, leaf, t_clip)

    def member(j, is_sphere, carry):
        prm, obj_f, _, _ = _crowd_member(crowd_refs, j)
        b = _crowd_bound(prm, is_sphere)
        sdf_j = _crowd_leaf_sdf(prm, is_sphere)
        t1, clip2 = _bound_entry(b, o, d, t_start, carry[3], exit_margin)
        t_j, hit_j = _march(sdf_j, o, d, F32(0.0), clip2, steps,
                            settings.hit_eps, t_init=t1,
                            relax=settings.over_relax,
                            eps_scale=settings.hit_eps_scale)
        return merge(carry, t_j, hit_j, obj_f)

    def member_pair(j, spec, carry):
        is_s0, is_s1, op = spec
        prm0, prm1, k, obj_f, _, _ = _crowd_member_pair(crowd_refs, j)
        b = _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k)
        sdf_j = _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k)
        t1, clip2 = _bound_entry(b, o, d, t_start, carry[3], exit_margin)
        t_j, hit_j = _march(sdf_j, o, d, F32(0.0), clip2, steps,
                            settings.hit_eps, t_init=t1,
                            relax=settings.over_relax,
                            eps_scale=settings.hit_eps_scale)
        return merge(carry, t_j, hit_j, obj_f)

    state = _crowd_sections(crowd.sdf_ranges, member, state)
    return _crowd_sections(crowd.pair_ranges, member_pair, state)


def _crowd_normals(crowd, crowd_refs, p, obj, settings, n):
    """Per-member normals, matching the unrolled path\'s per-engine
    selection: SDF members always take the 4-tap FD tetrahedron on
    their OWN SDF (cond-gated per tile); analytic members take the
    closed-form leaf normal under normals="auto" and FD under "fd"."""
    from surfjax.engines.analytic import leaf_normal
    from surfjax.core.scene_compile import LEAF_BOX, LEAF_SPHERE

    def member_fd(j, is_sphere, carry):
        nx, ny, nz = carry
        prm, obj_f, _, _ = _crowd_member(crowd_refs, j)
        sdf_j = _crowd_leaf_sdf(prm, is_sphere)
        sel = obj == obj_f
        won = jnp.where(sel, F32(1.0), F32(0.0))
        n_s = jax.lax.cond(
            jnp.max(won) > F32(0.5),
            lambda: _fd_normal(sdf_j, p, settings.normal_eps),
            lambda: (jnp.zeros_like(p[0]), jnp.zeros_like(p[0]),
                     jnp.ones_like(p[0])))
        return (jnp.where(sel, n_s[0], nx), jnp.where(sel, n_s[1], ny),
                jnp.where(sel, n_s[2], nz))

    def member_analytic(j, is_sphere, carry):
        nx, ny, nz = carry
        prm, obj_f, _, _ = _crowd_member(crowd_refs, j)
        kind = LEAF_SPHERE if is_sphere else LEAF_BOX
        n_s = leaf_normal(kind, prm, p)
        sel = obj == obj_f
        return (jnp.where(sel, n_s[0], nx), jnp.where(sel, n_s[1], ny),
                jnp.where(sel, n_s[2], nz))

    def member_fd_pair(j, spec, carry):
        # pairs are SDF-engine: FD tetrahedron on the pair SDF in both
        # normals modes (same as the unrolled path's SDF objects)
        nx, ny, nz = carry
        is_s0, is_s1, op = spec
        prm0, prm1, k, obj_f, _, _ = _crowd_member_pair(crowd_refs, j)
        sdf_j = _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k)
        sel = obj == obj_f
        won = jnp.where(sel, F32(1.0), F32(0.0))
        n_s = jax.lax.cond(
            jnp.max(won) > F32(0.5),
            lambda: _fd_normal(sdf_j, p, settings.normal_eps),
            lambda: (jnp.zeros_like(p[0]), jnp.zeros_like(p[0]),
                     jnp.ones_like(p[0])))
        return (jnp.where(sel, n_s[0], nx), jnp.where(sel, n_s[1], ny),
                jnp.where(sel, n_s[2], nz))

    if settings.normals == "auto":
        n = _crowd_sections(crowd.sdf_ranges, member_fd, n)
        n = _crowd_sections(crowd.ana_ranges, member_analytic, n)
    else:
        n = _crowd_sections(crowd.all_ranges, member_fd, n)
    return _crowd_sections(crowd.pair_ranges, member_fd_pair, n)


def _crowd_ao_terms(crowd, crowd_refs, p_off, n, settings, terms,
                    n_terms: int):
    """Per-member AO tap terms with the same 2*ao_radius far gate as
    _ao_compute, max-combined (exactly equal to scene-min terms)."""
    from surfjax.engines.sdf import ao_probe_terms

    def gated_terms(bound, sdf_j, terms):
        cx, cy, cz, R = bound
        dx = p_off[0] - cx
        dy = p_off[1] - cy
        dz = p_off[2] - cz
        hb = jnp.sqrt((dx * dx + dy * dy) + dz * dz) - R
        pred = jnp.min(hb) <= F32(2.0) * F32(settings.ao_radius)
        t_j = jax.lax.cond(
            pred,
            lambda: tuple(ao_probe_terms(sdf_j, p_off, n,
                                         settings.ao_samples,
                                         settings.ao_radius)),
            lambda: tuple(jnp.zeros_like(p_off[0])
                          for _ in range(n_terms)))
        return tuple(jnp.maximum(a, b) for a, b in zip(terms, t_j))

    def member(j, is_sphere, terms):
        prm, _, _, _ = _crowd_member(crowd_refs, j)
        return gated_terms(_crowd_bound(prm, is_sphere),
                           _crowd_leaf_sdf(prm, is_sphere), terms)

    def member_pair(j, spec, terms):
        # pair bound includes the k/4 smooth margin, so it stays a
        # pointwise lower bound of the pair SDF — the far gate is sound
        is_s0, is_s1, op = spec
        prm0, prm1, k, _, _, _ = _crowd_member_pair(crowd_refs, j)
        return gated_terms(
            _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k),
            _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k), terms)

    terms = _crowd_sections(crowd.all_ranges, member, terms)
    return _crowd_sections(crowd.pair_ranges, member_pair, terms)


def _crowd_hard_vis(crowd, crowd_refs, o, l, dist, settings, steps: int,
                    eps, eps_margin: float, state):
    """Crowd section of the hard-shadow path: per-member any-hit march
    with the segment skip + bound entry/exit clip (sphere/box covers are
    exact — no iterated-DE envelope caveat). state/-> vis."""
    def march_occluder(b, sdf_j, vis):
        dist_j = jnp.where(vis <= F32(0.0), F32(0.0), dist)
        dseg = _seg_bound_dist(b, o, l, F32(eps), dist_j)
        dist_j = jnp.where(dseg > F32(eps_margin), F32(0.0), dist_j)
        t1, clip2 = _bound_entry(b, o, l, F32(eps) * jnp.ones_like(dist_j),
                                 dist_j, eps_margin)
        t_s, hit_s = _march(sdf_j, o, l, F32(0.0), clip2, steps,
                            settings.hit_eps, t_init=t1,
                            relax=settings.over_relax,
                            eps_scale=settings.hit_eps_scale)
        occ = (hit_s > F32(0.5)) & (t_s < dist_j)
        return vis * jnp.where(occ, F32(0.0), F32(1.0))

    def member(j, is_sphere, carry):
        prm, _, _, _ = _crowd_member(crowd_refs, j)
        return march_occluder(_crowd_bound(prm, is_sphere),
                              _crowd_leaf_sdf(prm, is_sphere), carry)

    def member_pair(j, spec, carry):
        is_s0, is_s1, op = spec
        prm0, prm1, k, _, _, _ = _crowd_member_pair(crowd_refs, j)
        return march_occluder(
            _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k),
            _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k), carry)

    def member_analytic(j, is_sphere, carry):
        # exact any-hit, same interval arithmetic as intersect_analytic\'s
        # single-leaf fast path (engines/analytic.py)
        prm, _, _, _ = _crowd_member(crowd_refs, j)
        t_j = _leaf_exact_t(prm, is_sphere, o, l, F32(eps), dist)
        return carry * jnp.where(t_j < dist, F32(0.0), F32(1.0))

    state = _crowd_sections(crowd.sdf_ranges, member, state)
    state = _crowd_sections(crowd.pair_ranges, member_pair, state)
    return _crowd_sections(crowd.ana_ranges, member_analytic, state)


def _crowd_soft_vis(crowd, crowd_refs, o, l, dist, settings, steps: int,
                    kf, state):
    """Crowd section of the soft-shadow path: spheres take the exact
    closed-form penumbra (zero march steps), boxes the influence-window
    march — the same per-kind strategy as the unrolled path.
    state/-> soft_vis."""
    tmin_s = F32(settings.soft_shadow_tmin)

    def windowed_march(b, sdf_j, soft_vis):
        dist_j = jnp.where(soft_vis <= F32(0.0), F32(0.0), dist)
        t_lo, t_hi = _influence_window(b, o, l, tmin_s, dist_j, kf)
        v_j = _soft_march(sdf_j, o, l, settings.soft_shadow_tmin,
                          jnp.minimum(dist_j, t_hi), kf, steps,
                          t_init=jnp.maximum(t_lo, tmin_s),
                          relax=settings.over_relax)
        return jnp.minimum(soft_vis, v_j)

    def member(j, is_sphere, carry):
        prm, _, _, _ = _crowd_member(crowd_refs, j)
        if is_sphere:
            v_j = _penumbra_sphere(prm, o, l, tmin_s, dist, kf)
            return jnp.minimum(carry, v_j)
        return windowed_march(_crowd_bound(prm, False),
                              _crowd_leaf_sdf(prm, False), carry)

    def member_pair(j, spec, carry):
        # no closed-form penumbra for a pair: influence-window march on
        # the pair SDF (the window bound carries the k/4 smooth margin,
        # keeping the pointwise-lower-bound property the window needs)
        is_s0, is_s1, op = spec
        prm0, prm1, k, _, _, _ = _crowd_member_pair(crowd_refs, j)
        return windowed_march(
            _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k),
            _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k), carry)

    state = _crowd_sections(crowd.all_ranges, member, state)
    return _crowd_sections(crowd.pair_ranges, member_pair, state)


def _crowd_shade(crowd, crowd_refs, mat_table, obj, hit_mask, ambient,
                 ao, n, v, light_terms, rgb):
    """Material gather (per-lane 9 channels by dynamic mat index) + one
    shade_object call per distinct static shininess group. Per-lane
    arithmetic equals the unrolled per-object shade (the gathered mat
    values are the lane's object's exact rows). rgb/-> (r, g, b)."""
    cm = crowd_refs[0]
    zeros = jnp.zeros_like(obj)

    def gather(j, carry):
        mats, grp, isc = carry
        _, obj_f, mat_i, g = _crowd_member(crowd_refs, j)
        sel = obj == obj_f
        mats = tuple(jnp.where(sel, mat_table[mat_i, k], mats[k])
                     for k in range(9))
        grp = jnp.where(sel, g, grp)
        isc = jnp.maximum(isc, jnp.where(sel, F32(1.0), F32(0.0)))
        return (mats, grp, isc)

    mats, grp, isc = _crowd_sections(
        crowd.gather_ranges, lambda j, _is, c: gather(j, c),
        (tuple(zeros for _ in range(9)), zeros, zeros))

    r, g, b = rgb
    for gi, shin in enumerate(crowd.shin_groups):
        ri, gi2, bi = shade_object(mats, shin, ambient, ao, n, v,
                                   light_terms)
        sel = hit_mask & (isc > F32(0.5)) & (grp == F32(float(gi)))
        r = jnp.where(sel, ri, r)
        g = jnp.where(sel, gi2, g)
        b = jnp.where(sel, bi, b)
    return r, g, b


def _crowd_obj_set(crowd):
    return frozenset(i for i, _ in crowd.members) if crowd else frozenset()


# ---------------------------------------------------------------------------
# The shared trace core — used by the Pallas kernel bodies AND by the jnp
# twin, so kernel-vs-twin parity tests exercise identical algorithms.
# ---------------------------------------------------------------------------

def trace_core(static, settings: RenderSettings, lp, nparams, o, d,
               t_min: float, t_max, crowd_refs=None):
    """-> (t, obj_id f32, leaf_id f32, hit_f f32). Analytic objects are
    intersected exactly over [t_min, t_max]; SDF objects are marched
    from t_min, each clipped by the nearest hit so far."""
    analytic, sdf_objs, _mesh = _split(static)
    # mesh objects are intersected by the packet kernel (mesh_tile.py) and
    # merged by the caller; this core handles analytic + SDF only
    crowd = None
    if crowd_refs is not None:
        crowd, ana_rest, sdf_rest = split_crowd(static, settings)
        if crowd is not None:
            analytic, sdf_objs = ana_rest, sdf_rest

    t_a = jnp.full_like(o[0], BIG)
    obj = jnp.full_like(o[0], -1.0)
    leaf = jnp.zeros_like(o[0])
    for i, oir in analytic:
        t_i, leaf_i = intersect_analytic(oir, lp, o, d, t_min, t_max)
        better = t_i < t_a
        t_a = jnp.where(better, t_i, t_a)
        obj = jnp.where(better, F32(float(i)), obj)
        leaf = jnp.where(better, leaf_i.astype(jnp.float32), leaf)
    if crowd is not None and crowd.has_ana:
        # exact analytic crowd hits merge into t_a BEFORE the SDF
        # marches so they clip the marches exactly like unrolled
        # analytic objects do
        t_a, obj, leaf = _crowd_analytic_trace(
            crowd, crowd_refs, o, d, t_min, t_max, (t_a, obj, leaf))

    t = t_a
    steps = settings.max_steps
    t_start = F32(t_min) * jnp.ones_like(o[0])
    # the march can register a hit only while eps_eff-close to the
    # object, i.e. inside its bound inflated by this margin — so
    # clipping at that sphere's exit is value-exact. Derived from the
    # ACTUAL clip distance (the t_max argument), not settings.t_max,
    # so the soundness invariant holds for any caller-passed range.
    exit_margin = settings.hit_eps + settings.hit_eps_scale * float(
        max(t_max, settings.t_max))
    if crowd is not None and crowd.has_sdf:
        t_clip = jnp.minimum(t_a, F32(t_max))
        t, obj, leaf, _ = _crowd_trace(
            crowd, crowd_refs, o, d, t_start, settings, steps,
            exit_margin, (t, obj, leaf, t_clip))
    if sdf_objs:
        # Per-object marches with PROGRESSIVE clipping: cheap objects march
        # first; each subsequent object's march is clipped by the nearest
        # hit so far (blocks occluded by a cheaper object never pay the
        # expensive tape), every march evaluates only its own object's
        # tape, and attribution is exact — no scene-min argmin.
        fast_fn = _fast_leaf_fn(settings)
        order = sorted(sdf_objs, key=lambda io: len(io[1].nodes))
        # t here includes any crowd hits (t == t_a when no crowd ran), so
        # the unrolled marches are progressively clipped by both
        t_clip = jnp.minimum(t, F32(t_max))
        for i, oir in order:
            sdf_i = (lambda oir=oir: lambda p: eval_sdf(
                oir, lp, nparams, p, leaf_fn=fast_fn))()
            park_i = _park_point(oir, lp)
            # every boundable object gets the closed-form sphere
            # entry/exit (see _bound_entry); unboundable ones (plane
            # leaves) march from t_start directly
            b_i = _object_bound(oir, lp, nparams, cover_margin=exit_margin)
            if b_i is not None:
                t1, clip2 = _bound_entry(
                    b_i, o, d, t_start, t_clip, exit_margin,
                    shell=_bulb_entry_shell(oir, lp, exit_margin))
            else:
                t1, clip2 = t_start, t_clip
            t_i, hit_i = _march(sdf_i, o, d, F32(0.0), clip2, steps,
                                settings.hit_eps, t_init=t1,
                                relax=settings.over_relax,
                                eps_scale=settings.hit_eps_scale,
                                park=park_i)
            better = (hit_i > F32(0.5)) & (t_i < t)
            t = jnp.where(better, t_i, t)
            obj = jnp.where(better, F32(float(i)), obj)
            leaf = jnp.where(better, F32(0.0), leaf)
            t_clip = jnp.minimum(t_clip, t)

    hit_f = jnp.where(t < BIG * F32(0.5), F32(1.0), F32(0.0))
    return t, obj, leaf, hit_f


def normals_core(static, settings: RenderSettings, lp, nparams, p, obj, leaf,
                 d, crowd_refs=None):
    """Normals for trace_core hits; face-forwarded. Matches the jnp
    pipeline's per-object selection (pipeline/frame.py): analytic
    objects get analytic normals only under normals="auto" (normals=
    "fd" switches them to the FD tetrahedron, same as jnp/golden), and
    each SDF object's FD taps evaluate that OBJECT's own tape — not the
    scene min — so contact seams between SDF objects agree with the
    oracles (review r3)."""
    analytic, sdf_objs, _ = _split(static)
    crowd = None
    if crowd_refs is not None:
        crowd, ana_rest, sdf_rest = split_crowd(static, settings)
        if crowd is not None:
            analytic, sdf_objs = ana_rest, sdf_rest
    nx = jnp.zeros_like(p[0])
    ny = jnp.zeros_like(p[0])
    nz = jnp.ones_like(p[0])
    if crowd is not None:
        # crowd members always take the FD tetrahedron on their own SDF
        # (exactly what the unrolled path does for SDF-engine objects
        # under both normals modes)
        nx, ny, nz = _crowd_normals(crowd, crowd_refs, p, obj, settings,
                                    (nx, ny, nz))
    fd_objs = list(sdf_objs)
    if settings.normals == "auto":
        for i, oir in analytic:
            n_i = object_normal_analytic(oir, lp, p, leaf.astype(jnp.int32))
            sel = obj == F32(float(i))
            nx = jnp.where(sel, n_i[0], nx)
            ny = jnp.where(sel, n_i[1], ny)
            nz = jnp.where(sel, n_i[2], nz)
    else:
        fd_objs = sorted(analytic + sdf_objs)
    for i, oir in fd_objs:
        # per-object FD, cond-gated: tiles with no lane won by this
        # object skip its 4-tap evaluation entirely (value-exact skip)
        sel = obj == F32(float(i))
        won = jnp.where(sel, F32(1.0), F32(0.0))
        sdf_i = (lambda oir=oir: lambda pp: eval_sdf(
            oir, lp, nparams, pp, leaf_fn=_fast_leaf_fn(settings)))()
        n_s = jax.lax.cond(
            jnp.max(won) > F32(0.5),
            (lambda sdf_i=sdf_i: _fd_normal(sdf_i, p,
                                            settings.normal_eps)),
            lambda: (jnp.zeros_like(p[0]), jnp.zeros_like(p[0]),
                     jnp.ones_like(p[0])))
        nx = jnp.where(sel, n_s[0], nx)
        ny = jnp.where(sel, n_s[1], ny)
        nz = jnp.where(sel, n_s[2], nz)
    flip = (nx * d[0] + ny * d[1]) + nz * d[2] > F32(0.0)
    s = jnp.where(flip, F32(-1.0), F32(1.0))
    return (nx * s, ny * s, nz * s)


def _penumbra_plane(prm, o, l, t0, t_max, kf):
    """Closed-form penumbra factor of a plane leaf: d(t) = a + b*t is
    linear, so f(t) = k*d(t)/t is monotone in t (f' = -k*a/t^2) and the
    continuum min over [t0, t_max] is at an endpoint. Exact — no march.
    Lanes with t_max <= t0 (no shadow segment) return 1."""
    a = ((prm[0] * o[0] + prm[1] * o[1]) + prm[2] * o[2]) - prm[3]
    b = (prm[0] * l[0] + prm[1] * l[1]) + prm[2] * l[2]
    tm = jnp.maximum(t_max, t0)
    f0 = kf * (a + b * t0) / t0
    f1 = kf * (a + b * tm) / tm
    res = jnp.minimum(f0, f1)
    res = jnp.where(t_max <= t0, F32(1.0), res)
    return jnp.minimum(jnp.maximum(res, F32(0.0)), F32(1.0))


def _penumbra_sphere(prm, o, l, t0, t_max, kf):
    """Closed-form penumbra factor of a sphere leaf.

    f(t) = k*(s(t) - R)/t with s(t) = |o + t*l - c|. Interior critical
    points satisfy b*t - A + R*s = 0, i.e. the roots of
        t^2 (b^2 - R^2) + 2 b t (R^2 - A) + A (A - R^2) = 0
    (b = dot(c-o, l), A = |c-o|^2). The global min over [t0, t_max] is at
    an endpoint or one of those roots; extra/spurious candidates only add
    values >= the min, so evaluating f at all four is exact."""
    cx, cy, cz, R = prm[0], prm[1], prm[2], prm[3]
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    A = (wx * wx + wy * wy) + wz * wz
    b = (wx * l[0] + wy * l[1]) + wz * l[2]

    def f(t):
        s = jnp.sqrt(jnp.maximum((t - b) * t + (A - b * t), F32(0.0)))
        return kf * (s - R) / t

    tm = jnp.maximum(t_max, t0)
    qa = b * b - R * R
    qb = b * (R * R - A)          # half the linear coefficient
    qc = A * (A - R * R)
    disc = qb * qb - qa * qc
    sq = jnp.sqrt(jnp.maximum(disc, F32(0.0)))
    safe_qa = jnp.where(jnp.abs(qa) < F32(1e-12), F32(1e-12), qa)
    r1 = jnp.clip((-qb - sq) / safe_qa, t0, tm)
    r2 = jnp.clip((-qb + sq) / safe_qa, t0, tm)
    r1 = jnp.where(disc >= F32(0.0), r1, t0)
    r2 = jnp.where(disc >= F32(0.0), r2, t0)
    res = jnp.minimum(jnp.minimum(f(t0), f(tm)), jnp.minimum(f(r1), f(r2)))
    res = jnp.where(t_max <= t0, F32(1.0), res)
    return jnp.minimum(jnp.maximum(res, F32(0.0)), F32(1.0))


def _single_leaf_closed_form(oir):
    """-> LEAF_PLANE / LEAF_SPHERE if the object is one positively-signed
    plane/sphere leaf (closed-form penumbra available), else None."""
    from surfjax.core.scene_compile import LEAF_PLANE, LEAF_SPHERE
    if len(oir.nodes) == 1 and len(oir.leaves) == 1:
        lf = oir.leaves[0]
        if lf.sign > 0 and lf.kind in (LEAF_PLANE, LEAF_SPHERE):
            return lf.kind
    return None


def _influence_window(b, o, l, t0, t_max, kf):
    """Per-lane [t_lo, t_hi] window outside of which object samples cannot
    lower the penumbra minimum below 1 (value-exact skip).

    Outside the window k*h(t)/t >= k*h_bound(t)/t >= 1 (h >= h_bound since
    the bound sphere is a pointwise lower bound of the object SDF), so a
    sample there leaves res (which starts at 1) unchanged. The window ends
    are the roots of k*(|o + t*l - c| - R) = t:
        t^2 (1 - 1/k^2) - 2 t (b + R/k) + (A - R^2) = 0.
    No real roots (or window outside [t0, t_max]) -> the object cannot
    darken this lane at all."""
    cx, cy, cz, R = b
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    A = (wx * wx + wy * wy) + wz * wz
    bb = (wx * l[0] + wy * l[1]) + wz * l[2]
    inv_k = F32(1.0) / kf
    qa = F32(1.0) - inv_k * inv_k
    qb = -(bb + R * inv_k)        # half the linear coefficient
    qc = A - R * R
    disc = qb * qb - qa * qc
    sq = jnp.sqrt(jnp.maximum(disc, F32(0.0)))
    safe_qa = jnp.maximum(qa, F32(1e-6))
    t_lo = (-qb - sq) / safe_qa
    t_hi = (-qb + sq) / safe_qa
    t_lo = jnp.maximum(t_lo, t0)
    t_hi = jnp.minimum(t_hi, t_max)
    empty = (disc < F32(0.0)) | (t_hi <= t_lo)
    t_lo = jnp.where(empty, t0, t_lo)
    t_hi = jnp.where(empty, F32(0.0), t_hi)
    # very soft penumbra (k near/below 1): the influence region is not a
    # bounded quadratic window — fall back to the full segment
    no_win = kf < F32(1.2)
    t_lo = jnp.where(no_win, t0, t_lo)
    t_hi = jnp.where(no_win, t_max, t_hi)
    return t_lo, t_hi


def _seg_bound_dist(b, o, l, t_lo, dist):
    """Per-lane distance from the shadow segment [t_lo, dist] to the
    bounding sphere b (>= 0 means the whole segment stays outside)."""
    cx, cy, cz, R = b
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    proj = (wx * l[0] + wy * l[1]) + wz * l[2]
    proj = jnp.clip(proj, t_lo, jnp.maximum(dist, t_lo))
    qx = wx - proj * l[0]
    qy = wy - proj * l[1]
    qz = wz - proj * l[2]
    return jnp.sqrt((qx * qx + qy * qy) + qz * qz) - R


def visibility_core(static, settings: RenderSettings, lp, nparams,
                    o, l, dist, soft_k=None, crowd_refs=None):
    """Shadow visibility for a batch of secondary rays (re-entry path).

    soft_k: per-ray penumbra sharpness (area lights: dist/radius); None
    falls back to the global settings.soft_shadow_k.

    Semantics match the jnp pipeline and the golden oracle: with soft
    shadows ON, every non-mesh object (analytic included — their tapes are
    exact SDFs) participates in the penumbra; with soft shadows OFF,
    analytic objects occlude exactly and SDF objects by march.

    Per-object penumbra evaluation strategy (pallas path):
      - single plane/sphere leaves: closed-form continuum minimum of
        k*d(t)/t — exact, zero march steps;
      - bounded objects: march only the per-lane influence window where
        k*h_bound(t)/t < 1 (samples outside provably cannot lower res);
      - the march itself over-relaxes by settings.over_relax with the
        same retreat-on-overshoot rule as the primary march."""
    analytic, sdf_objs, _ = _split(static)
    crowd = None
    if crowd_refs is not None:
        crowd, ana_rest, sdf_rest = split_crowd(static, settings)
        if crowd is not None:
            analytic, sdf_objs = ana_rest, sdf_rest
    vis = jnp.ones_like(o[0])
    eps = settings.shadow_eps

    if settings.soft_shadows and (analytic or sdf_objs or crowd):
        from surfjax.core.scene_compile import LEAF_PLANE
        # per-object penumbra factors combine by MIN exactly
        # (saturate(min_t k*min_i d_i/t) == min_i saturate(min_t k*d_i/t));
        # cheap objects first, and lanes already fully dark skip the rest
        nonmesh = sorted(analytic + sdf_objs,
                         key=lambda io: len(io[1].nodes))
        k = soft_k if soft_k is not None else settings.soft_shadow_k
        kf = k if hasattr(k, "shape") else F32(k)
        t0 = F32(settings.soft_shadow_tmin)
        lod_fn = _lod_leaf_fn(settings) or _fast_leaf_fn(settings)
        steps = settings.shadow_steps
        soft_vis = jnp.ones_like(o[0])
        if crowd is not None:
            soft_vis = _crowd_soft_vis(crowd, crowd_refs, o, l, dist,
                                       settings, steps, kf, soft_vis)
        for i, oir in nonmesh:
            cf = _single_leaf_closed_form(oir)
            if cf is not None:
                prm = lp[oir.leaves[0].slot]
                if cf == LEAF_PLANE:
                    v_i = _penumbra_plane(prm, o, l, t0, dist, kf)
                else:
                    v_i = _penumbra_sphere(prm, o, l, t0, dist, kf)
                soft_vis = jnp.minimum(soft_vis, v_i)
                continue
            sdf_i = (lambda oir=oir: lambda p: eval_sdf(
                oir, lp, nparams, p, leaf_fn=lod_fn))()
            dist_i = jnp.where(soft_vis <= F32(0.0), F32(0.0), dist)
            # influence windows skip where k*h_bound/t >= 1: needs the
            # POINTWISE lower-bound sphere (see BULB_BOUND_LOWER)
            b = _object_bound(oir, lp, nparams, lower=True)
            park_i = _park_point(oir, lp)
            tmin_s = F32(settings.soft_shadow_tmin)
            if b is not None:
                # march only the influence window (value-exact skip)
                t_lo, t_hi = _influence_window(b, o, l, t0, dist_i, kf)
                v_i = _soft_march(sdf_i, o, l, settings.soft_shadow_tmin,
                                  jnp.minimum(dist_i, t_hi), k, steps,
                                  t_init=jnp.maximum(t_lo, tmin_s),
                                  relax=settings.over_relax, park=park_i)
            else:
                v_i = _soft_march(sdf_i, o, l, settings.soft_shadow_tmin,
                                  dist_i, k, steps,
                                  relax=settings.over_relax, park=park_i)
            soft_vis = jnp.minimum(soft_vis, v_i)
        return vis * soft_vis
    steps = settings.max_steps
    for _, oir in analytic:
        t_i, _ = intersect_analytic(oir, lp, o, l, eps, dist)
        vis = vis * jnp.where(t_i < dist, F32(0.0), F32(1.0))
    if crowd is not None:
        eps_margin = settings.hit_eps + settings.hit_eps_scale * float(
            settings.t_max)
        vis = _crowd_hard_vis(crowd, crowd_refs, o, l, dist, settings,
                              steps, eps, eps_margin, vis)
    if sdf_objs:
        # per-object any-hit marches; occluded lanes skip later objects
        order = sorted(sdf_objs, key=lambda io: len(io[1].nodes))
        for i, oir in order:
            sdf_i = (lambda oir=oir: lambda p: eval_sdf(
                oir, lp, nparams, p, leaf_fn=_fast_leaf_fn(settings)))()
            dist_i = jnp.where(vis <= F32(0.0), F32(0.0), dist)
            # shadow marches use the same cone epsilon as the jnp twin
            # and goldens (sphere_trace(..., hit_eps_scale) on the
            # shadow path); the skip/entry margins below are widened to
            # the worst eps_eff over the whole segment so they stay
            # sound (review r3: eps_scale was dropped here, making the
            # kernel under-occlude vs the oracles at eps_scale > 0)
            eps_margin = settings.hit_eps + settings.hit_eps_scale * float(
                settings.t_max)
            # hard-shadow gating needs only the hit-region COVER: an
            # occlusion (h < eps_eff <= eps_margin) implies the point is
            # inside the margin-validated cover sphere, so both the
            # segment skip and the entry/exit clip are sound (advisor r3:
            # cover_margin keeps this true past eps ~ 0.045*bulb scale)
            b = _object_bound(oir, lp, nparams, cover_margin=eps_margin)
            park_i = _park_point(oir, lp)
            if b is not None:
                # segment clears the bound by more than the worst-case
                # hit epsilon: the march cannot register an occlusion
                dseg = _seg_bound_dist(b, o, l, F32(eps), dist)
                dist_i = jnp.where(dseg > F32(eps_margin), F32(0.0),
                                   dist_i)
                # closed-form bound entry/exit replaces the proxy phase
                t1, clip2 = _bound_entry(b, o, l,
                                         F32(eps) * jnp.ones_like(dist_i),
                                         dist_i, eps_margin)
                t_s, hit_s = _march(sdf_i, o, l, F32(0.0), clip2, steps,
                                    settings.hit_eps, t_init=t1,
                                    relax=settings.over_relax,
                                    eps_scale=settings.hit_eps_scale,
                                    park=park_i)
            else:
                t_s, hit_s = _march(sdf_i, o, l, eps, dist_i, steps,
                                    settings.hit_eps,
                                    relax=settings.over_relax,
                                    eps_scale=settings.hit_eps_scale,
                                    park=park_i)
            occ = (hit_s > F32(0.5)) & (t_s < dist_i)
            vis = vis * jnp.where(occ, F32(0.0), F32(1.0))
    return vis


def _soft_march(sdf_fn, o, d, t_start, t_max, k, steps: int,
                t_init=None, relax: float = 1.0, park=None):
    """Penumbra march. relax > 1 over-relaxes exactly like the primary
    march (_march): step by relax*step; if consecutive safety spheres no
    longer overlap (st_prev > h_prev + |h|), retreat to the conservative
    point (t - st_prev) + h_prev and resume relaxed stepping from there —
    the retreat point lies ON the previous safety sphere, so no occluder
    (or penumbra minimum narrower than a safety sphere) is skipped. Every
    evaluated sample is a true SDF value, so accumulating it into res is
    always sound — including at overshot positions."""
    kf = k if hasattr(k, "shape") else F32(k)
    w = F32(relax)
    t0 = jnp.full_like(o[0], t_start) if t_init is None else t_init
    res0 = jnp.ones_like(o[0])
    done0 = jnp.where(t0 > t_max, F32(1.0), F32(0.0))
    z0 = jnp.zeros_like(o[0])

    def cond(s):
        i, _, _, _, _, done = s
        return (i < steps) & (jnp.min(done) < F32(0.5))

    def substep(t, res, h_prev, st_prev, done):
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        if park is not None:
            # done lanes evaluate at the far park point (value-exact:
            # their res/t/h_prev/st_prev are frozen by the done mask) so
            # a lane stopped at the darkness floor — h ~ 0, ON the set —
            # cannot pin the while-DE at full iterations (see _march)
            parked = done > F32(0.5)
            px = jnp.where(parked, park[0], px)
            py = jnp.where(parked, park[1], py)
            pz = jnp.where(parked, park[2], pz)
        h = sdf_fn((px, py, pz))
        if relax > 1.0:
            ovr = jnp.where(st_prev > h_prev + jnp.abs(h),
                            F32(1.0), F32(0.0))
        else:
            ovr = z0
        ok = F32(1.0) - ovr
        res_new = jnp.minimum(res, kf * h / t)
        # res-aware adaptive step: within a stretch where k*d/t' provably
        # stays >= res (d >= h - s, t' <= t + s => s <= (k*h - res*t)/
        # (k + res)), no sample can lower the running minimum — skipping is
        # exact, and the allowed step grows as the penumbra darkens
        s_allowed = (kf * h - res_new * t) / (kf + res_new)
        cap = jnp.maximum(F32(0.5), s_allowed)
        step = jnp.minimum(jnp.maximum(w * h, F32(1e-3)), cap)
        t_fwd = t + step
        t_retreat = (t - st_prev) + h_prev  # unrelaxed fallback point
        t_new = jnp.where(ovr > F32(0.5), t_retreat, t_fwd)
        # penumbra floor: below 1/255 the factor is visually zero; the
        # t_max check uses the ACTUAL next position (forward or retreat)
        # so no lane ever samples beyond the light segment
        done_new = jnp.maximum(
            done,
            jnp.maximum(jnp.where(res_new < F32(0.004), F32(1.0),
                                  F32(0.0)),
                        jnp.where(t_new > t_max, F32(1.0), F32(0.0))))
        res = jnp.where(done > F32(0.5), res, res_new)
        t = jnp.where(done > F32(0.5), t, t_new)
        h_prev = jnp.where(done_new > F32(0.5), h_prev, ok * h)
        st_prev = jnp.where(done_new > F32(0.5), st_prev, ok * step)
        return t, res, h_prev, st_prev, done_new

    # largest unroll dividing the budget keeps the step count exact
    unroll = next(u for u in range(min(SOFT_MARCH_UNROLL, steps), 0, -1)
                  if steps % u == 0)

    def body(s):
        i, t, res, h_prev, st_prev, done = s
        for _ in range(unroll):
            t, res, h_prev, st_prev, done = substep(t, res, h_prev,
                                                    st_prev, done)
        return i + unroll, t, res, h_prev, st_prev, done

    _, _, res, _, _, _ = jax.lax.while_loop(
        cond, body, (0, t0, res0, z0, z0, done0))
    return jnp.minimum(jnp.maximum(res, F32(0.0)), F32(1.0))


# ---------------------------------------------------------------------------
# Pallas kernels
# ---------------------------------------------------------------------------



def _ao_compute(static, settings, lp, nparams, p, n,
                already_offset: bool = False, crowd_refs=None):
    """AO probes over every non-mesh object (matching the jnp pipeline and
    golden), with an EXACT PER-OBJECT tile-level skip for bounded
    objects: taps lie within ao_radius of the (eps-offset) receiver, so
    if every lane is more than 2*ao_radius outside object i's bounding
    sphere, d_i >= ao_radius >= az*r at every tap and object i cannot
    contribute to any tap's occlusion term. Each bounded object's tap
    terms ride their own lax.cond and combine by elementwise max — bit
    identical to the scene-min evaluation (max(az*r - min_j h_j, 0) ==
    max_j max(az*r - h_j, 0); see engines/sdf.py::ao_probe_terms), so a
    tile near only the blob no longer pays the bulb's iterated DE at
    every tap. Unboundable objects (planes — cheap SDFs) are always
    evaluated; with everything far and no plane, ao is exactly 1.

    already_offset: p is a pre-offset receiver (mesh hits offset along the
    geometric normal by the caller, matching golden/renderer.py)."""
    from surfjax.engines.sdf import (
        _AO_DIRS, ao_probe_terms, ao_terms_to_factor,
    )
    analytic, sdf_only, _ = _split(static)
    crowd = None
    if crowd_refs is not None:
        crowd, ana_rest, sdf_rest = split_crowd(static, settings)
        if crowd is not None:
            analytic, sdf_only = ana_rest, sdf_rest
    sdf_objs = analytic + sdf_only  # AO probes every non-mesh object
    eps = F32(settings.shadow_eps)
    if already_offset:
        p_off = p
    else:
        p_off = (p[0] + n[0] * eps, p[1] + n[1] * eps, p[2] + n[2] * eps)

    cap = settings.ao_lod_iters or settings.secondary_lod_iters
    lod_fn = (_capped_leaf_fn(cap, settings) if cap
              else _fast_leaf_fn(settings))

    def terms_of(objs):
        fn = lambda pp: _scene_sdf(objs, lp, nparams, pp, leaf_fn=lod_fn)
        return tuple(ao_probe_terms(fn, p_off, n, settings.ao_samples,
                                    settings.ao_radius))

    unbounded = []
    gated = []
    for i, oir in sdf_objs:
        # the far-gate claims d_i >= ao_radius at every tap: needs the
        # POINTWISE lower-bound sphere (see BULB_BOUND_LOWER)
        b = _object_bound(oir, lp, nparams, lower=True)
        if b is None:
            unbounded.append((i, oir))
            continue
        cx, cy, cz, R = b
        dx = p_off[0] - cx
        dy = p_off[1] - cy
        dz = p_off[2] - cz
        hb = jnp.sqrt((dx * dx + dy * dy) + dz * dz) - R
        gated.append(((i, oir), hb))

    terms = terms_of(unbounded) if unbounded else None
    n_terms = min(settings.ao_samples, len(_AO_DIRS)) * 4
    if crowd is not None:
        if terms is None:
            terms = tuple(jnp.zeros_like(p_off[0]) for _ in range(n_terms))
        terms = _crowd_ao_terms(crowd, crowd_refs, p_off, n, settings,
                                terms, n_terms)
    for (i, oir), hb in gated:
        pred = jnp.min(hb) <= F32(2.0) * F32(settings.ao_radius)
        t_i = jax.lax.cond(
            pred,
            (lambda oir=oir, i=i: terms_of([(i, oir)])),
            lambda: tuple(jnp.zeros_like(p_off[0])
                          for _ in range(n_terms)))
        terms = (t_i if terms is None
                 else tuple(jnp.maximum(a, b_) for a, b_ in
                            zip(terms, t_i)))
    if terms is None:  # no objects at all
        return jnp.ones_like(p[0])
    return ao_terms_to_factor(terms, settings.ao_samples,
                              settings.ao_strength)


def _k1_body(static, settings, n_leaves, n_nodes,
             lp_ref, np_ref, cm_ref,
             ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
             t_ref, obj_ref, nx_ref, ny_ref, nz_ref, ao_ref, hit_ref):
    lp, nparams = _read_params(lp_ref, np_ref, n_leaves, n_nodes)
    crowd_refs = (cm_ref, lp_ref, np_ref)
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t, obj, leaf, hit_f = trace_core(static, settings, lp, nparams, o, d,
                                     settings.t_min, settings.t_max,
                                     crowd_refs=crowd_refs)
    t_sane = jnp.where(hit_f > F32(0.5), t, F32(0.0))
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    n = normals_core(static, settings, lp, nparams, p, obj, leaf, d,
                     crowd_refs=crowd_refs)

    analytic, sdf_objs, _ = _split(static)
    # AO probes the full non-mesh scene SDF — analytic objects included
    # (their tapes are exact SDFs), matching golden/renderer.py and the
    # jnp pipeline's _nonmesh_scene_sdf
    if settings.ao and (analytic or sdf_objs):
        ao = _ao_compute(static, settings, lp, nparams, p, n,
                         crowd_refs=crowd_refs)
    else:
        ao = jnp.ones_like(p[0])

    t_ref[...] = t
    obj_ref[...] = obj
    nx_ref[...] = n[0]
    ny_ref[...] = n[1]
    nz_ref[...] = n[2]
    ao_ref[...] = ao
    hit_ref[...] = hit_f


def _ao_fix_body(static, settings, n_leaves, n_nodes,
                 lp_ref, np_ref, cm_ref,
                 px_ref, py_ref, pz_ref, nx_ref, ny_ref, nz_ref,
                 need_ref, ao_in_ref, ao_ref):
    """AO at externally-supplied (pre-offset) receivers — used to fix up
    mesh-hit lanes after the mesh merge so pallas == jnp == golden on
    mesh+SDF+AO scenes. Blocks with no needing lane pass ao through."""
    lp, nparams = _read_params(lp_ref, np_ref, n_leaves, n_nodes)
    p = (px_ref[...], py_ref[...], pz_ref[...])
    n = (nx_ref[...], ny_ref[...], nz_ref[...])
    need = need_ref[...]
    ao_in = ao_in_ref[...]

    def compute():
        ao_new = _ao_compute(static, settings, lp, nparams, p, n,
                             already_offset=True,
                             crowd_refs=(cm_ref, lp_ref, np_ref))
        return jnp.where(need > F32(0.5), ao_new, ao_in)

    ao_ref[...] = jax.lax.cond(jnp.max(need) > F32(0.5), compute,
                               lambda: ao_in)


def _k2_body(static, settings, n_leaves, n_nodes,
             lp_ref, np_ref, cm_ref,
             ox_ref, oy_ref, oz_ref, lx_ref, ly_ref, lz_ref, dist_ref,
             k_ref, vis_ref):
    lp, nparams = _read_params(lp_ref, np_ref, n_leaves, n_nodes)
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    l = (lx_ref[...], ly_ref[...], lz_ref[...])
    vis_ref[...] = visibility_core(static, settings, lp, nparams, o, l,
                                   dist_ref[...], soft_k=k_ref[...],
                                   crowd_refs=(cm_ref, lp_ref, np_ref))


def _ray_specs(n_arrays: int, rows: int):
    return [pl.BlockSpec((rows, LANES), lambda i: (i, 0))
            for _ in range(n_arrays)]


def _whole_specs(n_arrays: int):
    """Small tables (scene params, crowd meta, cameras, lights,
    materials) passed whole to every block and read by scalar loads."""
    return [pl.BlockSpec() for _ in range(n_arrays)]


def _ray_call(body, static, settings, leaf_params, node_params, rays,
              n_out: int):
    """One program per tile_rows x 128 block of (rows_total, 128) rays;
    body gets (leaf params, node params, crowd meta, *rays, *outputs)."""
    rows_total = rays[0].shape[0]
    R = settings.tile_rows
    n_leaves = max(static.ir.n_leaves, 1)
    n_nodes = node_params.shape[0]
    shp = jax.ShapeDtypeStruct((rows_total, LANES), jnp.float32)
    return _pallas(
        functools.partial(body, static, settings, n_leaves, n_nodes),
        grid=(rows_total // R,),
        in_specs=_whole_specs(3) + _ray_specs(len(rays), R),
        out_specs=tuple(_ray_specs(n_out, R)),
        out_shape=(shp,) * n_out, tile_rows=R,
    )(leaf_params, node_params, crowd_meta(static, settings), *rays)


@functools.partial(jax.jit, static_argnums=(0, 1))
def ao_fix_kernel(static, settings: RenderSettings, leaf_params,
                  node_params, p_off, n, need, ao_in):
    """Recompute AO for `need` lanes at pre-offset receivers p_off."""
    ao, = _ray_call(_ao_fix_body, static, settings, leaf_params,
                    node_params, (*p_off, *n, need, ao_in), 1)
    return ao


@functools.partial(jax.jit, static_argnums=(0, 1))
def render_tile_kernel(static, settings: RenderSettings, leaf_params,
                       node_params, o, d):
    """K1 over a padded (rows_total, 128) ray grid.
    -> (t, obj, (nx, ny, nz), ao, hit_f)."""
    t, obj, nx, ny, nz, ao, hit_f = _ray_call(
        _k1_body, static, settings, leaf_params, node_params, (*o, *d), 7)
    return t, obj, (nx, ny, nz), ao, hit_f


@functools.partial(jax.jit, static_argnums=(0, 1))
def trace_rays_kernel(static, settings: RenderSettings, leaf_params,
                      node_params, o, l, dist, soft_k):
    """K2: batched secondary-ray visibility (same intersection core)."""
    vis, = _ray_call(_k2_body, static, settings, leaf_params, node_params,
                     (*o, *l, dist, soft_k), 1)
    return vis


# ---------------------------------------------------------------------------
# KF: the fused mesh-free frame kernel. One pallas_call renders F frames:
# per-block ray generation from program_id (no ray arrays in device
# memory at all), primary trace, normals, AO, per-light shadow visibility
# and Blinn-Phong shading — the K1 -> XLA glue -> K2 -> XLA shade
# pipeline collapses into one pass over registers. Exact same cores
# (trace_core / normals_core / _ao_compute / visibility_core /
# shade_object) as the split path, so parity is structural.
# ---------------------------------------------------------------------------


def tile_shape(tile_rows: int) -> Tuple[int, int]:
    """(rows, cols) of the pixel patch one tile_rows x 128 block covers;
    the block's rays are that patch in row-major order."""
    return tile_rows * LANES // TILE_W, TILE_W


class FrameTiles(NamedTuple):
    """Padded tiling of an H x W frame into tile patches."""
    th: int   # patch rows
    tw: int   # patch cols
    ty: int   # patches down
    tx: int   # patches across
    R: int    # block rows of 128 rays

    @property
    def rows_total(self):
        return self.ty * self.tx * self.R

    def tile(self, a):
        """(ty*th, tx*tw) image -> (rows_total, 128) block layout."""
        return (a.reshape(self.ty, self.th, self.tx, self.tw)
                .transpose(0, 2, 1, 3).reshape(self.rows_total, LANES))

    def untile(self, a, H: int, W: int):
        """(..., rows_total, 128) block layout -> (..., H, W) image."""
        lead = a.shape[:-2]
        a = a.reshape(lead + (self.ty, self.tx, self.th, self.tw))
        n = len(lead)
        a = jnp.moveaxis(a, n + 2, n + 1)
        return a.reshape(lead + (self.ty * self.th, self.tx * self.tw))[
            ..., :H, :W]


def frame_tiles(intr, tile_rows: int) -> FrameTiles:
    th, tw = tile_shape(tile_rows)
    return FrameTiles(th, tw, -(-intr.height // th), -(-intr.width // tw),
                      tile_rows)


def _kframe_body(static, settings, n_leaves, n_nodes, intr, tiles,
                 lp_ref, np_ref, cm_ref, cam_ref, li_ref, mat_ref, amb_ref,
                 r_ref, g_ref, b_ref, t_ref, obj_ref,
                 nx_ref, ny_ref, nz_ref, hit_ref):
    from surfjax.core.math import vnormalize
    from surfjax.core.scene_compile import LIGHT_POINT
    lp, nparams = _read_params(lp_ref, np_ref, n_leaves, n_nodes)
    crowd_refs = (cm_ref, lp_ref, np_ref)
    crowd, _, _ = split_crowd(static, settings)
    R = tiles.R

    # ray generation from the grid index (exact same arithmetic as
    # core/camera.py::camera_ray_dirs_dyn on the edge-clamped pixel grid
    # FrameTiles.tile builds). The grid covers F frames x patches; each
    # frame reads its own camera row.
    gidx = pl.program_id(0)
    per_frame = tiles.ty * tiles.tx
    frame = gidx // per_frame
    local = gidx % per_frame
    row0 = (local // tiles.tx) * tiles.th
    col0 = (local % tiles.tx) * tiles.tw
    k = (jax.lax.broadcasted_iota(jnp.int32, (R, LANES), 0) * LANES
         + jax.lax.broadcasted_iota(jnp.int32, (R, LANES), 1))
    rr = jnp.minimum((row0 + k // tiles.tw).astype(jnp.float32),
                     F32(intr.height - 1))
    cc = jnp.minimum((col0 + k % tiles.tw).astype(jnp.float32),
                     F32(intr.width - 1))
    xc = (cc + F32(0.5) - F32(intr.cx)) / F32(intr.fx)
    yc = (rr + F32(0.5) - F32(intr.cy)) / F32(intr.fy)
    dxd = (cam_ref[frame, 0] * xc + cam_ref[frame, 1] * yc) \
        + cam_ref[frame, 2]
    dyd = (cam_ref[frame, 3] * xc + cam_ref[frame, 4] * yc) \
        + cam_ref[frame, 5]
    dzd = (cam_ref[frame, 6] * xc + cam_ref[frame, 7] * yc) \
        + cam_ref[frame, 8]
    d = vnormalize((dxd, dyd, dzd))
    zeros = jnp.zeros_like(rr)
    o = (zeros + cam_ref[frame, 9], zeros + cam_ref[frame, 10],
         zeros + cam_ref[frame, 11])

    t, obj, leaf, hit_f = trace_core(static, settings, lp, nparams, o, d,
                                     settings.t_min, settings.t_max,
                                     crowd_refs=crowd_refs)
    t_sane = jnp.where(hit_f > F32(0.5), t, F32(0.0))
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    n = normals_core(static, settings, lp, nparams, p, obj, leaf, d,
                     crowd_refs=crowd_refs)

    analytic, sdf_objs, _ = _split(static)
    if settings.ao and (analytic or sdf_objs):
        ao = _ao_compute(static, settings, lp, nparams, p, n,
                         crowd_refs=crowd_refs)
    else:
        ao = jnp.ones_like(p[0])

    eps = F32(settings.shadow_eps)
    p_off = (p[0] + n[0] * eps, p[1] + n[1] * eps, p[2] + n[2] * eps)

    light_terms = []
    for li, kind in enumerate(static.ir.lights):
        lrow = tuple(li_ref[li, k] for k in range(7))
        if kind == LIGHT_POINT:
            lvx = lrow[0] - p_off[0]
            lvy = lrow[1] - p_off[1]
            lvz = lrow[2] - p_off[2]
            dist = jnp.sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
            inv = F32(1.0) / dist
            l = (lvx * inv, lvy * inv, lvz * inv)
        else:
            l = (zeros - lrow[0], zeros - lrow[1], zeros - lrow[2])
            dist = zeros + F32(settings.t_max)
        lcol = (lrow[3], lrow[4], lrow[5])
        if settings.shadows:
            radius = lrow[6]
            soft_k = jnp.where(radius > F32(0.0), dist / radius,
                               jnp.full_like(dist,
                                             settings.soft_shadow_k))
            dist_eff = jnp.where(hit_f > F32(0.5), dist, F32(0.0))
            vis = visibility_core(static, settings, lp, nparams, p_off, l,
                                  dist_eff, soft_k=soft_k,
                                  crowd_refs=crowd_refs)
        else:
            vis = jnp.ones_like(p_off[0])
        light_terms.append((l, lcol, vis))

    v = (-d[0], -d[1], -d[2])
    ambient = (amb_ref[0], amb_ref[1], amb_ref[2])
    bg = settings.background
    r = zeros + F32(bg[0])
    g = zeros + F32(bg[1])
    b = zeros + F32(bg[2])
    hit_mask = hit_f > F32(0.5)
    crowd_objs = _crowd_obj_set(crowd)
    for i, oir in enumerate(static.ir.objects):
        if i in crowd_objs:
            continue  # crowd members shade via the gathered-material loop
        mat_row = tuple(mat_ref[oir.mat, k] for k in range(9))
        ri, gi, bi = shade_object(mat_row, oir.shininess, ambient, ao, n,
                                  v, light_terms)
        sel = hit_mask & (obj == F32(float(i)))
        r = jnp.where(sel, ri, r)
        g = jnp.where(sel, gi, g)
        b = jnp.where(sel, bi, b)
    if crowd is not None:
        r, g, b = _crowd_shade(crowd, crowd_refs, mat_ref, obj, hit_mask,
                               ambient, ao, n, v, light_terms, (r, g, b))

    r_ref[...] = r
    g_ref[...] = g
    b_ref[...] = b
    t_ref[...] = t_sane
    obj_ref[...] = obj
    nx_ref[...] = n[0]
    ny_ref[...] = n[1]
    nz_ref[...] = n[2]
    hit_ref[...] = hit_f


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def frame_fused_kernel(static, settings: RenderSettings, intr,
                       leaf_params, node_params, cam_rows, lights,
                       materials, ambient):
    """KF over F frames x the padded patch grid, ONE pallas call.

    cam_rows: (F, 12) [R_flat(9), pos(3)] per frame — the whole
    animated-path workload (BASELINE.json:11) runs as a single grid of
    F * patches programs, so per-frame dispatch/scan overhead vanishes.
    Returns (r, g, b, t, obj, nx, ny, nz, hit_f), each
    (F * rows_total, 128) in FrameTiles block layout."""
    tiles = frame_tiles(intr, settings.tile_rows)
    F = cam_rows.shape[0]
    R = settings.tile_rows
    rows_all = F * tiles.rows_total
    n_leaves = max(static.ir.n_leaves, 1)
    n_nodes = node_params.shape[0]
    body = functools.partial(_kframe_body, static, settings, n_leaves,
                             n_nodes, intr, tiles)
    shp = jax.ShapeDtypeStruct((rows_all, LANES), jnp.float32)
    return _pallas(
        body,
        grid=(rows_all // R,),
        in_specs=_whole_specs(7),
        out_specs=tuple(_ray_specs(9, R)),
        out_shape=(shp,) * 9, tile_rows=R,
    )(leaf_params, node_params, crowd_meta(static, settings), cam_rows,
      lights, materials, ambient)


# ---------------------------------------------------------------------------
# jnp twin of the kernel algorithm (SURVEY.md §4.3)
# ---------------------------------------------------------------------------

def scene_march_twin(static, settings: RenderSettings, leaf_params,
                     node_params, o, d):
    """Pure-jnp twin of K1 on flat rays (no tiling, no Pallas)."""
    lp = leaf_params
    nparams = node_params
    # the twin mirrors the crowd path too (dynamic reads hit jnp arrays
    # instead of kernel refs — same indices, same arithmetic)
    crowd_refs = (crowd_meta(static, settings), leaf_params, node_params)
    t, obj, leaf, hit_f = trace_core(static, settings, lp, nparams, o, d,
                                     settings.t_min, settings.t_max,
                                     crowd_refs=crowd_refs)
    t_sane = jnp.where(hit_f > F32(0.5), t, F32(0.0))
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    n = normals_core(static, settings, lp, nparams, p, obj, leaf, d,
                     crowd_refs=crowd_refs)
    analytic, sdf_objs, _ = _split(static)
    if settings.ao and (analytic or sdf_objs):
        ao = _ao_compute(static, settings, lp, nparams, p, n,
                         crowd_refs=crowd_refs)
    else:
        ao = jnp.ones_like(p[0])
    return t, obj, n, ao, hit_f


# ---------------------------------------------------------------------------
# Full pallas-backend frame: K1 -> secondary batches -> K2 -> shade (XLA)
# ---------------------------------------------------------------------------

MAX_TILE_ROWS = 8  # 1,024 rays per block: at most 4 rays per thread


def _validate_pallas_settings(settings: RenderSettings) -> None:
    """Refuse settings the Triton route cannot compile (block shapes must
    be powers of two) or that would spill every ray's march state out of
    registers, before any kernel is traced."""
    R = settings.tile_rows
    if R <= 0 or R & (R - 1) or R > MAX_TILE_ROWS:
        raise ValueError(
            f"tile_rows must be a power of two in [1, {MAX_TILE_ROWS}] "
            f"(Triton block shapes are powers of two); got {R}")
    if settings.max_steps <= 0 or settings.shadow_steps <= 0:
        raise ValueError(
            f"step budgets must be positive; got max_steps="
            f"{settings.max_steps}, shadow_steps={settings.shadow_steps}")
    if settings.bulb_iter not in ("std", "cheb"):
        raise ValueError(
            f"bulb_iter must be 'std' or 'cheb'; got "
            f"{settings.bulb_iter!r}")


def _maybe_warn_crowd(static, settings: RenderSettings) -> None:
    """Large scene + flag off -> point the user at vector_objects (the
    statically-unrolled path traces and compiles every object anew)."""
    if settings.vector_objects:
        return
    probe = split_crowd(static, settings.with_(vector_objects=True))[0]
    if probe is not None and len(probe.members) >= 24:
        import warnings
        warnings.warn(
            f"scene has {len(probe.members)} crowd-eligible objects; "
            "the statically-unrolled pallas path compiles every object "
            "separately — consider RenderSettings(vector_objects=True) "
            "(compile cost independent of the crowd size, bitwise-equal "
            "geometry)", RuntimeWarning)


def _fused_buffers(outs, tiles: FrameTiles, H: int, W: int,
                   lead=()) -> FrameBuffers:
    """KF outputs -> FrameBuffers of shape lead + (H, W[, 3])."""
    r, g, b, t, obj, nx, ny, nz, hit_f = (
        tiles.untile(a.reshape(lead + (tiles.rows_total, LANES)), H, W)
        for a in outs)
    return FrameBuffers(
        rgb=jnp.stack([r, g, b], axis=-1),
        depth=t,
        normal=jnp.stack([nx * hit_f, ny * hit_f, nz * hit_f], axis=-1),
        hit=hit_f,
        obj_id=jnp.where(hit_f > F32(0.5), obj.astype(jnp.int32),
                         jnp.int32(-1)),
    )


def render_frame_pallas(static, intr, settings: RenderSettings, params,
                        R_flat, cam_pos) -> FrameBuffers:
    """Full pallas frame over pixel-patch tiles (see tile_shape).

    Each tile_rows x 128 kernel block is a patch *of the image*, not a
    row-major strip — spatial coherence is what makes the per-block
    early exit pay (a sky patch exits in a few steps; a fractal patch
    runs long without holding the rest of the frame hostage).
    Returns flat row-major FrameBuffers of length H*W.
    """
    from surfjax.core.camera import camera_ray_dirs_dyn

    _validate_pallas_settings(settings)
    _maybe_warn_crowd(static, settings)
    H, W = intr.height, intr.width
    tiles = frame_tiles(intr, settings.tile_rows)

    # mesh-free frames take KF, the fused kernel (ray gen + trace + AO +
    # shadows + shading in ONE pallas pass — no ray/G-buffer round trips
    # through device memory, no XLA glue); mesh scenes keep the split
    # K1 -> merge -> K2 pipeline.
    if fused_frame_ok(static):
        cam_rows = jnp.concatenate([R_flat.reshape(-1),
                                    cam_pos.reshape(-1)])[None, :]
        outs = frame_fused_kernel(
            static, settings, intr, params["leaf_params"],
            params["node_params"], cam_rows, params["lights"],
            params["materials"], params["ambient"])
        fb = _fused_buffers(outs, tiles, H, W)
        return FrameBuffers(*(a.reshape((H * W,) + a.shape[2:])
                              for a in fb))

    rows = jnp.minimum(jnp.arange(tiles.ty * tiles.th, dtype=jnp.float32),
                       F32(H - 1))
    cols = jnp.minimum(jnp.arange(tiles.tx * tiles.tw, dtype=jnp.float32),
                       F32(W - 1))
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    rr_t = tiles.tile(rr)
    cc_t = tiles.tile(cc)
    d = camera_ray_dirs_dyn(intr, R_flat, rr_t, cc_t)
    o = tuple(jnp.broadcast_to(cam_pos[k], rr_t.shape) for k in range(3))
    fb = _render_padded(static, settings, params, o, d)

    def untile(a):
        return tiles.untile(a.reshape(rr_t.shape), H, W).reshape(-1)

    return FrameBuffers(
        rgb=jnp.stack([untile(fb.rgb[..., k]) for k in range(3)], axis=-1),
        depth=untile(fb.depth),
        normal=jnp.stack([untile(fb.normal[..., k]) for k in range(3)],
                         axis=-1),
        hit=untile(fb.hit),
        obj_id=untile(fb.obj_id.astype(jnp.float32)).astype(jnp.int32),
    )


def fused_frame_ok(static) -> bool:
    """True when a frame can take KF (the fused kernel): a mesh-free
    scene. Mesh merges keep the split K1 -> K2 pipeline."""
    _, _, mesh_objs = _split(static)
    return not mesh_objs


def render_sequence_pallas(static, intr, settings: RenderSettings, params,
                           R_flats, positions) -> FrameBuffers:
    """F-frame animated path as ONE fused pallas call (grid = F x patches).

    BASELINE.json:11's 128-frame on-device sequence: per-frame cameras
    are rows of a small table every block reads, so there is no per-frame
    dispatch, scan step or XLA glue at all. Caller must check
    fused_frame_ok. Returns FrameBuffers stacked on a leading frame
    axis: rgb (F, H, W, 3), depth/hit (F, H, W), ..."""
    _validate_pallas_settings(settings)
    _maybe_warn_crowd(static, settings)
    F = R_flats.shape[0]
    cam_rows = jnp.concatenate(
        [R_flats.reshape(F, 9), positions.reshape(F, 3)], axis=1)
    outs = frame_fused_kernel(
        static, settings, intr, params["leaf_params"],
        params["node_params"], cam_rows, params["lights"],
        params["materials"], params["ambient"])
    return _fused_buffers(outs, frame_tiles(intr, settings.tile_rows),
                          intr.height, intr.width, lead=(F,))


def _pad_rays(arrs, rows: int):
    """Flat (N,) ray components -> (rows_total, 128) padded by edge-repeat."""
    n = arrs[0].shape[0]
    block = rows * LANES
    n_pad = ((n + block - 1) // block) * block
    out = []
    for a in arrs:
        a = jnp.pad(a, (0, n_pad - n), mode="edge")
        out.append(a.reshape(n_pad // LANES, LANES))
    return tuple(out), n


def render_rays_pallas(static, settings: RenderSettings, params, o, d
                       ) -> FrameBuffers:
    """Pallas-backend render of a flat ray batch (pads to tile multiple)."""
    _validate_pallas_settings(settings)
    (ox, oy, oz, dx, dy, dz), n_rays = _pad_rays(
        (o[0], o[1], o[2], d[0], d[1], d[2]), settings.tile_rows)
    fb = _render_padded(static, settings, params,
                        (ox, oy, oz), (dx, dy, dz))

    def unpad(a):
        return a[:n_rays] if a.ndim == 1 else a[:n_rays, :]

    return FrameBuffers(rgb=unpad(fb.rgb), depth=unpad(fb.depth),
                        normal=unpad(fb.normal), hit=unpad(fb.hit),
                        obj_id=unpad(fb.obj_id))


def _pallas_primary(static, settings: RenderSettings, params, o2, d2):
    """Primary stage of the pallas frame on (rows_total, 128)-tiled rays:
    K1 -> mesh packet-kernel merge -> AO fix at mesh receivers.
    -> (t, obj, n, n_geom, ao, hit_f); t is the raw march t (callers mask
    by hit_f). Shared by _render_padded and the differentiable hybrid
    forward (surfjax/diff/hybrid.py), so the fit path's hit-finding is
    the identical compiled program."""
    ir = static.ir
    _, _, mesh = _split(static)

    lp = params["leaf_params"]
    nparams = params["node_params"]
    ox, oy, oz = o2
    dx, dy, dz = d2
    # non-mesh scene (a scene of ONLY meshes still needs the blank frame)
    t, obj, n, ao, hit_f = render_tile_kernel(
        static, settings, lp, nparams, (ox, oy, oz), (dx, dy, dz))

    # mesh objects: packet kernel per mesh; merge nearest
    n_geom = n
    mesh_won = jnp.zeros_like(ox)
    if mesh:
        from surfjax.kernels.mesh_tile import mesh_tile_kernel
        for i, oir in mesh:
            ms = static.mesh_static[oir.mesh]
            tri_packed = jnp.asarray(
                _mesh_params(params, oir.mesh)["tri_packed"])
            t_m, n_s, n_g = mesh_tile_kernel(
                ms, settings, tri_packed, (ox, oy, oz), (dx, dy, dz),
                settings.t_max)
            better = t_m < jnp.where(hit_f > F32(0.5), t, BIG)
            t = jnp.where(better, t_m, t)
            obj = jnp.where(better, F32(float(i)), obj)
            hit_f = jnp.maximum(hit_f, jnp.where(better, F32(1.0), F32(0.0)))
            # face-forward both shading and geometric mesh normals
            def _ff(nv):
                flip = (nv[0] * dx + nv[1] * dy) + nv[2] * dz > F32(0.0)
                s = jnp.where(flip, F32(-1.0), F32(1.0))
                return (nv[0] * s, nv[1] * s, nv[2] * s)
            n_s = _ff(n_s)
            n_g = _ff(n_g)
            n = (jnp.where(better, n_s[0], n[0]),
                 jnp.where(better, n_s[1], n[1]),
                 jnp.where(better, n_s[2], n[2]))
            n_geom = (jnp.where(better, n_g[0], n_geom[0]),
                      jnp.where(better, n_g[1], n_geom[1]),
                      jnp.where(better, n_g[2], n_geom[2]))
            mesh_won = jnp.maximum(mesh_won,
                                   jnp.where(better, F32(1.0), F32(0.0)))

    t_sane = jnp.where(hit_f > F32(0.5), t, F32(0.0))
    p = (ox + t_sane * dx, oy + t_sane * dy, oz + t_sane * dz)
    eps = F32(settings.shadow_eps)
    # offset along the geometric normal (shadow-terminator safety for
    # smooth-shaded meshes; n == n_geom for non-mesh hits)
    p_off = (p[0] + n_geom[0] * eps, p[1] + n_geom[1] * eps,
             p[2] + n_geom[2] * eps)

    # AO at mesh-winning lanes: K1's fused AO probed its own (pre-merge)
    # hit points, so recompute at the merged receivers against the
    # non-mesh scene SDF — matching golden/renderer.py and the jnp
    # pipeline (both probe AO at every hit, mesh included)
    if mesh and settings.ao and (len(ir.objects) > len(mesh)):
        ao = ao_fix_kernel(static, settings, lp, nparams, p_off, n,
                           mesh_won, ao)
    return t, obj, n, n_geom, ao, hit_f


def _pallas_vis(static, settings: RenderSettings, params, p_off, l,
                dist_eff, soft_k):
    """One light's shadow visibility on (rows, 128)-tiled receivers:
    K2 -> mesh any-hit occlusion. Shared by _render_padded and the
    hybrid fit forward."""
    lp = params["leaf_params"]
    nparams = params["node_params"]
    _, _, mesh = _split(static)
    vis = trace_rays_kernel(static, settings, lp, nparams, p_off, l,
                            dist_eff, soft_k)
    if mesh:
        from surfjax.kernels.mesh_tile import mesh_tile_kernel
        for _, oir in mesh:
            ms = static.mesh_static[oir.mesh]
            tri_packed = jnp.asarray(
                _mesh_params(params, oir.mesh)["tri_packed"])
            t_m, _, _ = mesh_tile_kernel(
                ms, settings, tri_packed, p_off, l, dist_eff, any_hit=True)
            vis = vis * jnp.where(t_m < dist_eff, F32(0.0), F32(1.0))
    return vis


def _render_padded(static, settings: RenderSettings, params, o2, d2
                   ) -> FrameBuffers:
    """Core pallas frame on (rows_total, 128)-tiled rays; flat outputs."""
    from surfjax.core.scene_compile import (
        LIGHT_DIRECTIONAL, LIGHT_POINT,
    )
    ir = static.ir
    lp = params["leaf_params"]
    nparams = params["node_params"]
    ox, oy, oz = o2
    dx, dy, dz = d2
    t, obj, n, n_geom, ao, hit_f = _pallas_primary(
        static, settings, params, o2, d2)
    t_sane = jnp.where(hit_f > F32(0.5), t, F32(0.0))
    p = (ox + t_sane * dx, oy + t_sane * dy, oz + t_sane * dz)
    eps = F32(settings.shadow_eps)
    p_off = (p[0] + n_geom[0] * eps, p[1] + n_geom[1] * eps,
             p[2] + n_geom[2] * eps)

    light_terms = []
    for li, kind in enumerate(ir.lights):
        lrow = params["lights"][li]
        if kind == LIGHT_POINT:
            lvx = lrow[0] - p_off[0]
            lvy = lrow[1] - p_off[1]
            lvz = lrow[2] - p_off[2]
            dist = jnp.sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
            inv = F32(1.0) / dist
            l = (lvx * inv, lvy * inv, lvz * inv)
        else:
            l = (jnp.full_like(p_off[0], -lrow[0]),
                 jnp.full_like(p_off[0], -lrow[1]),
                 jnp.full_like(p_off[0], -lrow[2]))
            dist = jnp.full_like(p_off[0], settings.t_max)
        lcol = (lrow[3], lrow[4], lrow[5])
        if settings.shadows:
            # area lights: penumbra sharpness k = dist / radius
            radius = lrow[6]
            soft_k = jnp.where(radius > F32(0.0), dist / radius,
                               jnp.full_like(dist,
                                             settings.soft_shadow_k))
            # miss lanes need no shadow ray: zero their march budget so
            # sky tiles exit K2 instantly
            dist_eff = jnp.where(hit_f > F32(0.5), dist, F32(0.0))
            vis = _pallas_vis(static, settings, params, p_off, l,
                              dist_eff, soft_k)
        else:
            vis = jnp.ones_like(p_off[0])
        light_terms.append((l, lcol, vis))

    v = (-dx, -dy, -dz)
    ambient = (params["ambient"][0], params["ambient"][1],
               params["ambient"][2])
    bg = settings.background
    r = jnp.full_like(p[0], bg[0])
    g = jnp.full_like(p[0], bg[1])
    b = jnp.full_like(p[0], bg[2])
    hit_mask = hit_f > F32(0.5)
    crowd, _, _ = split_crowd(static, settings)
    crowd_objs = _crowd_obj_set(crowd)
    for i, oir in enumerate(ir.objects):
        if i in crowd_objs:
            continue  # crowd members shade via the gathered-material loop
        mat_row = params["materials"][oir.mat]
        ri, gi, bi = shade_object(mat_row, oir.shininess, ambient, ao, n, v,
                                  light_terms)
        sel = hit_mask & (obj == F32(float(i)))
        r = jnp.where(sel, ri, r)
        g = jnp.where(sel, gi, g)
        b = jnp.where(sel, bi, b)
    if crowd is not None:
        # split-path shading runs in XLA: dynamic reads hit the jnp
        # materials/meta arrays directly (same arithmetic as in-kernel)
        r, g, b = _crowd_shade(
            crowd, (crowd_meta(static, settings), lp, nparams),
            params["materials"], obj, hit_mask, ambient, ao, n, v,
            light_terms, (r, g, b))

    def flat(a):
        return a.reshape(-1)

    hitf = flat(hit_f)
    return FrameBuffers(
        rgb=jnp.stack([flat(r), flat(g), flat(b)], axis=-1),
        depth=flat(t_sane),
        normal=jnp.stack([flat(n[0]) * hitf, flat(n[1]) * hitf,
                          flat(n[2]) * hitf], axis=-1),
        hit=hitf,
        obj_id=jnp.where(hitf > F32(0.5), flat(obj).astype(jnp.int32),
                         jnp.int32(-1)),
    )
