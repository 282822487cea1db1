"""Differentiable PALLAS fit forward (component 19; VERDICT r4 Next #3).

SURVEY.md §3.3 puts the Pallas stack (3.1) in the fit forward; the
Pallas kernels have no AD rule. The key structural fact (engines/sdf.py
IFT adjoint):
the backward pass needs only eval_sdf's vjp AT THE HIT POINTS — not a
differentiable forward. So this module runs every march (primary K1,
shadow K2) in the non-differentiable Pallas kernels and reconstructs the
gradient paths around them:

  t        — `_reattach_t`, a frame-level jax.custom_vjp: identity in
             the forward (the kernel's t), the implicit-function-theorem
             adjoint in the backward, evaluated per winning object
             (same formula + silhouette clamp as engines/sdf.py
             `_sphere_trace_bwd`; mesh-winning lanes use the triangle
             plane as the defining function, whose spatial gradient is
             the geometric normal).
  normals/AO — recomputed differentiably in jnp AT THE HIT POINTS
             (4 resp. samples*4 SDF evals per hit pixel — no march) and
             spliced with `_splice` so the VALUE is bitwise the kernel's
             and the GRADIENT is the jnp reconstruction's.
  shadow visibility — Pallas K2 under stop_gradient. This matches the
             jnp path's semantics exactly: hard visibility is piecewise
             constant (zero gradient) and the soft penumbra march is
             already stop_gradient-ed there (pipeline/frame.py
             light_visibility — the standard visibility-gradient bias,
             SURVEY.md §7 hard part 4).

The forward VALUE is bitwise identical to render_rays_pallas (asserted
by tests/test_hybrid.py): it calls the same `_pallas_primary` /
`_pallas_vis` stages and the same shade tail, and every splice adds an
exact float zero. Gradients match the jnp pipeline's to FP tolerance:
the IFT gradient is invariant under the choice of defining function
(both f and phi(f) with phi'(0)>0 give the same -(df/dtheta)/(grad f.d)),
so SDF-IFT here vs closed-form-root AD there agree mathematically even
for analytic objects.

Scope: crowd scenes (RenderSettings.vector_objects with eligible
members) are rejected — fit scenes are small; use backend='jnp' there.
Mesh-winning lanes carry pose gradients via the plane IFT but zero
parameter gradients (mesh vertices are not fit parameters), and their
normal gradients are zero (the jnp path's barycentric-normal
sensitivity is a second-order effect at fixed triangle).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surfjax.core.math import F32, vdot
from surfjax.core.scene_compile import (
    ENGINE_MESH, LIGHT_POINT, SceneWithMeshes,
)
from surfjax.core.types import FrameBuffers, RenderSettings
from surfjax.engines.sdf import (
    _IFT_DENOM_CLAMP, ao_probes, eval_sdf, normal_fd,
)
from surfjax.kernels.render_tile import (
    _pad_rays, _pallas_primary, _pallas_vis, split_crowd,
)
from surfjax.shade import shade_object


def _splice(diff, value):
    """Exact-value / diff-gradient splice: returns `value` bitwise (adds
    the exact float zero diff - stop_grad(diff)) while the gradient is
    d(diff)/d(theta). Used to keep the hybrid's forward bitwise equal to
    the pure Pallas path while gradients flow through the cheap jnp
    reconstruction."""
    sg = jax.lax.stop_gradient
    return sg(value) + (diff - sg(diff))


# ---------------------------------------------------------------------------
# Frame-level IFT reattachment (the custom_vjp around the Pallas trace)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _reattach_t(static: SceneWithMeshes, settings: RenderSettings,
                lp, nparams, o, d, t, obj_f, hit_f, n_geom):
    """Identity on the kernel-computed hit distance t, with the IFT
    adjoint as its vjp — the hybrid's differentiable t."""
    return t


def _reattach_t_fwd(static, settings, lp, nparams, o, d, t, obj_f, hit_f,
                    n_geom):
    return t, (lp, nparams, o, d, t, obj_f, hit_f, n_geom)


def _reattach_t_bwd(static, settings, res, g_t):
    lp, nparams, o, d, t, obj_f, hit_f, n_geom = res
    hit = hit_f > F32(0.5)
    t_safe = jnp.where(hit, t, F32(0.0))
    p = (o[0] + t_safe * d[0], o[1] + t_safe * d[1], o[2] + t_safe * d[2])

    nonmesh = [(i, oir) for i, oir in enumerate(static.ir.objects)
               if oir.engine != ENGINE_MESH]
    mesh_ids = [i for i, oir in enumerate(static.ir.objects)
                if oir.engine == ENGINE_MESH]

    # the winning object's defining function per lane (non-mesh lanes);
    # analytic objects use their SDF form — the IFT gradient does not
    # depend on the choice of defining function (module docstring)
    def f(lp_, np_, px, py, pz):
        out = jnp.zeros_like(px)
        for i, oir in nonmesh:
            v = eval_sdf(oir, lp_, np_, (px, py, pz))
            out = jnp.where(obj_f == F32(float(i)), v, out)
        return out

    if nonmesh:
        _, vjp = jax.vjp(f, lp, nparams, *p)
        _, _, gx, gy, gz = vjp(jnp.ones_like(t))
    else:
        gx = jnp.zeros_like(t)
        gy = jnp.zeros_like(t)
        gz = jnp.zeros_like(t)

    is_mesh = jnp.zeros_like(t, dtype=bool)
    for i in mesh_ids:
        is_mesh = is_mesh | (obj_f == F32(float(i)))
    if mesh_ids:
        # triangle-plane defining function: grad f = geometric normal
        gx = jnp.where(is_mesh, n_geom[0], gx)
        gy = jnp.where(is_mesh, n_geom[1], gy)
        gz = jnp.where(is_mesh, n_geom[2], gz)

    denom = (gx * d[0] + gy * d[1]) + gz * d[2]
    # same silhouette clamp + rationale as engines/sdf._sphere_trace_bwd
    clamp = F32(_IFT_DENOM_CLAMP)
    denom = jnp.where(jnp.abs(denom) < clamp,
                      jnp.where(denom >= F32(0.0), clamp, -clamp),
                      denom)
    scale = jnp.where(hit, -g_t / denom, F32(0.0))

    scale_sdf = jnp.where(is_mesh, F32(0.0), scale)
    if nonmesh:
        g_lp, g_np, sgx, sgy, sgz = vjp(scale_sdf)
    else:
        g_lp = jnp.zeros_like(lp)
        g_np = jnp.zeros_like(nparams)
        sgx = jnp.zeros_like(t)
        sgy = jnp.zeros_like(t)
        sgz = jnp.zeros_like(t)
    if mesh_ids:
        scale_m = jnp.where(is_mesh, scale, F32(0.0))
        sgx = sgx + scale_m * n_geom[0]
        sgy = sgy + scale_m * n_geom[1]
        sgz = sgz + scale_m * n_geom[2]
    g_o = (sgx, sgy, sgz)
    g_d = (t_safe * sgx, t_safe * sgy, t_safe * sgz)
    zero = lambda a: jax.tree.map(jnp.zeros_like, a)
    return (g_lp, g_np, g_o, g_d, zero(t), zero(obj_f), zero(hit_f),
            zero(n_geom))


_reattach_t.defvjp(_reattach_t_fwd, _reattach_t_bwd)


# ---------------------------------------------------------------------------
# The hybrid forward
# ---------------------------------------------------------------------------

def _normals_diff(static, settings, lp, nparams, p, obj_f, d, n_kernel):
    """Differentiable normal carrier at the hit points: FD-tetrahedron of
    the winning non-mesh object (face-forwarded like the pipeline);
    mesh lanes keep the (stop-gradient) kernel normal."""
    sg = jax.lax.stop_gradient
    nx, ny, nz = sg(n_kernel[0]), sg(n_kernel[1]), sg(n_kernel[2])
    for i, oir in enumerate(static.ir.objects):
        if oir.engine == ENGINE_MESH:
            continue
        n_i = normal_fd(oir, lp, nparams, p, settings.normal_eps)
        flip = vdot(n_i, d) > F32(0.0)
        s = jnp.where(flip, F32(-1.0), F32(1.0))
        sel = obj_f == F32(float(i))
        nx = jnp.where(sel, n_i[0] * s, nx)
        ny = jnp.where(sel, n_i[1] * s, ny)
        nz = jnp.where(sel, n_i[2] * s, nz)
    return (nx, ny, nz)


def _scene_sdf_diff(static, lp, nparams):
    """min over non-mesh objects — the differentiable AO receiver SDF
    (same composition as pipeline/frame._nonmesh_scene_sdf)."""
    objs = [oir for oir in static.ir.objects if oir.engine != ENGINE_MESH]
    if not objs:
        return None

    def f(p):
        v = eval_sdf(objs[0], lp, nparams, p)
        for oir in objs[1:]:
            v = jnp.minimum(v, eval_sdf(oir, lp, nparams, p))
        return v
    return f


def render_rays_hybrid(static: SceneWithMeshes, settings: RenderSettings,
                       params, o, d) -> FrameBuffers:
    """Pallas-forward, IFT-backward render of a flat ray batch.

    Value: bitwise equal to render_rays_pallas (same kernel stages, same
    shade tail, exact-zero splices). Gradients: t via `_reattach_t`,
    normals/AO via differentiable jnp recomputation at the hit points,
    visibility stop-gradient (module docstring)."""
    ir = static.ir
    sg = jax.lax.stop_gradient
    crowd, _, _ = split_crowd(static, settings)
    if crowd is not None:
        raise NotImplementedError(
            "render_rays_hybrid: crowd scenes (vector_objects) have no "
            "differentiable hybrid path; fit with backend='jnp' or "
            "vector_objects=False.")

    (ox, oy, oz, dx, dy, dz), n_rays = _pad_rays(
        (o[0], o[1], o[2], d[0], d[1], d[2]), settings.tile_rows)
    o2 = (ox, oy, oz)
    d2 = (dx, dy, dz)
    lp = params["leaf_params"]
    nparams = params["node_params"]

    # every march runs in the kernels on stop-gradient inputs (pallas has
    # no AD rule; gradients re-enter via _reattach_t / splices below)
    t_k, obj, n_k, n_geom, ao_k, hit_f = _pallas_primary(
        static, settings, sg(params), sg(o2), sg(d2))

    t = _reattach_t(static, settings, lp, nparams, o2, d2,
                    t_k, obj, hit_f, n_geom)
    hit_mask = hit_f > F32(0.5)
    t_sane = jnp.where(hit_mask, t, F32(0.0))
    p = (ox + t_sane * dx, oy + t_sane * dy, oz + t_sane * dz)

    n_d = _normals_diff(static, settings, lp, nparams, p, obj, d2, n_k)
    n = tuple(_splice(n_d[k], n_k[k]) for k in range(3))
    n_off = tuple(_splice(n_d[k], n_geom[k]) for k in range(3))
    eps = F32(settings.shadow_eps)
    p_off = (p[0] + n_off[0] * eps, p[1] + n_off[1] * eps,
             p[2] + n_off[2] * eps)

    if settings.ao:
        sdf = _scene_sdf_diff(static, lp, nparams)
        if sdf is not None:
            ao_d = ao_probes(sdf, p_off, n, settings.ao_samples,
                             settings.ao_radius, settings.ao_strength)
            ao = _splice(ao_d, ao_k)
        else:
            ao = ao_k
    else:
        ao = ao_k

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
            radius = lrow[6]
            soft_k = jnp.where(radius > F32(0.0), dist / radius,
                               jnp.full_like(dist, settings.soft_shadow_k))
            dist_eff = jnp.where(hit_f > F32(0.5), dist, F32(0.0))
            vis = sg(_pallas_vis(static, settings, sg(params), sg(p_off),
                                 sg(l), sg(dist_eff), sg(soft_k)))
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
    for i, oir in enumerate(ir.objects):
        mat_row = params["materials"][oir.mat]
        ri, gi, bi = shade_object(mat_row, oir.shininess, ambient, ao, n, v,
                                  light_terms)
        sel = hit_mask & (obj == F32(float(i)))
        r = jnp.where(sel, ri, r)
        g = jnp.where(sel, gi, g)
        b = jnp.where(sel, bi, b)

    def flat(a):
        return a.reshape(-1)[:n_rays]

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
