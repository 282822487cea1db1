"""Integrator / frame pipeline (SURVEY.md §2 component 18, §3.1/§3.2).

One frame: primary tile pass -> hits -> normals -> secondary-ray batches
(hard/soft shadows toward lights, AO hemisphere probes) re-entering the same
intersection path batched [BASELINE.json:5] -> combined shade -> FrameBuffers.
Everything stays on device; the only host/device crossings are dispatch-in and
framebuffer-out (SURVEY.md §3.1).

The pure-jax.numpy path here is the *twin* of the Pallas kernel path
(surfjax/kernels/) and is selected with RenderSettings.backend == "jnp".
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from surfjax.core.camera import Intrinsics, camera_ray_dirs_dyn
from surfjax.core.math import BIG, F32, vdot
from surfjax.core.scene_compile import (
    ENGINE_ANALYTIC, ENGINE_MESH, ENGINE_SDF,
    LIGHT_DIRECTIONAL, LIGHT_POINT, SceneWithMeshes,
)
from surfjax.core.types import FrameBuffers, Hit, RenderSettings
from surfjax.engines.analytic import intersect_analytic, object_normal_analytic
from surfjax.engines.sdf import (
    ao_probes, eval_sdf, normal_fd, soft_shadow_march, sphere_trace,
)
from surfjax.shade import shade_object


# ---------------------------------------------------------------------------
# Scene-level intersection (dispatch over engines, SURVEY.md §2 comp 4/6/14)
# ---------------------------------------------------------------------------

def trace_scene(static: SceneWithMeshes, settings: RenderSettings, params,
                o, d, t_min, t_max) -> Hit:
    """Nearest hit over all scene objects for a flat ray batch."""
    ir = static.ir
    t_best = jnp.full_like(o[0], BIG)
    obj_best = jnp.full_like(o[0], -1, dtype=jnp.int32)
    leaf_best = jnp.zeros_like(o[0], dtype=jnp.int32)
    for i, oir in enumerate(ir.objects):
        if oir.engine == ENGINE_ANALYTIC:
            t_i, leaf_i = intersect_analytic(
                oir, params["leaf_params"], o, d, t_min, t_max)
        elif oir.engine == ENGINE_SDF:
            t_i, _hit = sphere_trace(
                oir, params["leaf_params"], params["node_params"], o, d,
                t_min, t_max, settings.max_steps, settings.hit_eps,
                settings.hit_eps_scale)
            leaf_i = jnp.zeros_like(t_i, dtype=jnp.int32)
        elif oir.engine == ENGINE_MESH:
            from surfjax.engines.mesh import intersect_mesh
            t_i, leaf_i = intersect_mesh(
                static.mesh_static[oir.mesh], oir.mesh, params, o, d,
                t_min, t_max)
        else:
            raise ValueError(f"unknown engine {oir.engine}")
        better = t_i < t_best
        t_best = jnp.where(better, t_i, t_best)
        obj_best = jnp.where(better, jnp.int32(i), obj_best)
        leaf_best = jnp.where(better, leaf_i, leaf_best)
    mask = t_best < BIG * F32(0.5)
    return Hit(t_best, obj_best, leaf_best, mask)


def _nonmesh_scene_sdf(static: SceneWithMeshes, params):
    """Scene-level SDF = min over all non-mesh objects (soft shadows / AO)."""
    sdf_objs = [oir for oir in static.ir.objects
                if oir.engine in (ENGINE_ANALYTIC, ENGINE_SDF)]
    if not sdf_objs:
        return None

    def f(p):
        v = eval_sdf(sdf_objs[0], params["leaf_params"],
                     params["node_params"], p)
        for oir in sdf_objs[1:]:
            v = jnp.minimum(v, eval_sdf(oir, params["leaf_params"],
                                        params["node_params"], p))
        return v
    return f


def compute_normals(static: SceneWithMeshes, settings: RenderSettings,
                    params, p, hit: Hit, d):
    """Per-hit surface normals: analytic where possible, FD-tetrahedron for
    SDF objects (component 8), face-forwarded against the ray."""
    ir = static.ir
    nx = jnp.zeros_like(p[0])
    ny = jnp.zeros_like(p[0])
    nz = jnp.ones_like(p[0])
    for i, oir in enumerate(ir.objects):
        if oir.engine == ENGINE_ANALYTIC and settings.normals == "auto":
            n_i = object_normal_analytic(oir, params["leaf_params"], p,
                                         hit.leaf_id)
        elif oir.engine in (ENGINE_ANALYTIC, ENGINE_SDF):
            n_i = normal_fd(oir, params["leaf_params"], params["node_params"],
                            p, settings.normal_eps)
        else:
            from surfjax.engines.mesh import mesh_normal
            n_i = mesh_normal(static.mesh_static[oir.mesh], oir.mesh, params,
                              p, hit.leaf_id)
        sel = hit.obj_id == jnp.int32(i)
        nx = jnp.where(sel, n_i[0], nx)
        ny = jnp.where(sel, n_i[1], ny)
        nz = jnp.where(sel, n_i[2], nz)
    # face-forward
    flip = vdot((nx, ny, nz), d) > F32(0.0)
    s = jnp.where(flip, F32(-1.0), F32(1.0))
    return (nx * s, ny * s, nz * s)


def light_visibility(static: SceneWithMeshes, settings: RenderSettings,
                     params, p_off, scene_sdf):
    """Per-light (direction, color, visibility) terms.

    Shadow rays are a batched re-entry into the same intersection code
    [BASELINE.json:5]. Hard shadows: occlusion trace against every object.
    Soft shadows: SDF penumbra march over the non-mesh scene SDF (+ hard
    occlusion from mesh objects).
    """
    ir = static.ir
    if settings.soft_shadows:
        nograd_params = jax.lax.stop_gradient(params)
        scene_sdf_nograd = _nonmesh_scene_sdf(static, nograd_params)
    terms = []
    for li, kind in enumerate(ir.lights):
        lrow = params["lights"][li]
        if kind == LIGHT_POINT:
            lvx = lrow[0] - p_off[0]
            lvy = lrow[1] - p_off[1]
            lvz = lrow[2] - p_off[2]
            dist = jnp.sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
            inv = F32(1.0) / dist
            l = (lvx * inv, lvy * inv, lvz * inv)
        else:  # directional: lrow[0:3] is the direction light travels
            l = (-lrow[0] * jnp.ones_like(p_off[0]),
                 -lrow[1] * jnp.ones_like(p_off[0]),
                 -lrow[2] * jnp.ones_like(p_off[0]))
            dist = jnp.full_like(p_off[0], settings.t_max)
        lcol = (lrow[3], lrow[4], lrow[5])

        vis = jnp.ones_like(p_off[0])
        if settings.shadows and ir.objects:
            if settings.soft_shadows and scene_sdf is not None:
                # visibility march is non-differentiable (while_loop);
                # cut gradients at its inputs — the standard visibility-
                # gradient bias of inverse rendering (SURVEY.md §7 part 4)
                sg = jax.lax.stop_gradient
                # area lights: penumbra sharpness k = dist / radius
                radius = lrow[6]
                soft_k = jnp.where(
                    radius > F32(0.0), dist / radius,
                    jnp.full_like(dist, settings.soft_shadow_k))
                vis = vis * soft_shadow_march(
                    scene_sdf_nograd, sg(p_off), sg(l),
                    settings.soft_shadow_tmin, sg(dist),
                    sg(soft_k), settings.shadow_steps)
                # mesh objects still occlude hard
                for oir in ir.objects:
                    if oir.engine == ENGINE_MESH:
                        from surfjax.engines.mesh import intersect_mesh
                        t_i, _ = intersect_mesh(
                            static.mesh_static[oir.mesh], oir.mesh, params,
                            p_off, l, settings.shadow_eps, dist)
                        vis = vis * jnp.where(t_i < dist, F32(0.0), F32(1.0))
            else:
                sh = trace_scene(static, settings, params, p_off, l,
                                 settings.shadow_eps, dist)
                vis = vis * jnp.where(sh.mask & (sh.t < dist),
                                      F32(0.0), F32(1.0))
        terms.append((l, lcol, vis))
    return terms


# ---------------------------------------------------------------------------
# Full shade of a flat ray batch
# ---------------------------------------------------------------------------

def render_rays(static: SceneWithMeshes, settings: RenderSettings, params,
                o, d) -> FrameBuffers:
    ir = static.ir
    hit = trace_scene(static, settings, params, o, d,
                      settings.t_min, settings.t_max)
    t = jnp.where(hit.mask, hit.t, F32(0.0))
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    n = compute_normals(static, settings, params, p, hit, d)
    # secondary-ray origins offset along the GEOMETRIC normal for meshes —
    # smooth (barycentric) normals can push the origin under the adjacent
    # facet's plane and produce shadow-terminator acne
    n_off = n
    for i, oir in enumerate(ir.objects):
        if oir.engine == ENGINE_MESH:
            from surfjax.engines.mesh import _mesh_arrays
            tri_n = _mesh_arrays(params, oir.mesh)["tri_n"][hit.leaf_id]
            gx, gy, gz = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
            flip = (gx * d[0] + gy * d[1]) + gz * d[2] > F32(0.0)
            s = jnp.where(flip, F32(-1.0), F32(1.0))
            sel = hit.obj_id == jnp.int32(i)
            n_off = (jnp.where(sel, gx * s, n_off[0]),
                     jnp.where(sel, gy * s, n_off[1]),
                     jnp.where(sel, gz * s, n_off[2]))
    eps = F32(settings.shadow_eps)
    p_off = (p[0] + n_off[0] * eps, p[1] + n_off[1] * eps,
             p[2] + n_off[2] * eps)

    scene_sdf = _nonmesh_scene_sdf(static, params)
    light_terms = light_visibility(static, settings, params, p_off, scene_sdf)

    if settings.ao and scene_sdf is not None:
        ao = ao_probes(scene_sdf, p_off, n, settings.ao_samples,
                       settings.ao_radius, settings.ao_strength)
    else:
        ao = jnp.ones_like(p[0])

    v = (-d[0], -d[1], -d[2])
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
        sel = hit.mask & (hit.obj_id == jnp.int32(i))
        r = jnp.where(sel, ri, r)
        g = jnp.where(sel, gi, g)
        b = jnp.where(sel, bi, b)

    hitf = hit.mask.astype(jnp.float32)
    return FrameBuffers(
        rgb=jnp.stack([r, g, b], axis=-1),
        depth=t,
        normal=jnp.stack([n[0] * hitf, n[1] * hitf, n[2] * hitf], axis=-1),
        hit=hitf,
        obj_id=jnp.where(hit.mask, hit.obj_id, jnp.int32(-1)),
    )


# ---------------------------------------------------------------------------
# Frame entry points
# ---------------------------------------------------------------------------

def _pixel_grid(intr: Intrinsics):
    rows = jnp.arange(intr.height, dtype=jnp.float32)
    cols = jnp.arange(intr.width, dtype=jnp.float32)
    rr, cc = jnp.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def frame_step(static, intr: Intrinsics, settings: RenderSettings, params,
               R_flat, cam_pos) -> FrameBuffers:
    """Trace+shade one full frame (flat), reshape to (H, W, ...)."""
    if settings.backend == "pallas":
        from surfjax.kernels.render_tile import render_frame_pallas
        fb = render_frame_pallas(static, intr, settings, params, R_flat,
                                 cam_pos)
    else:
        rr, cc = _pixel_grid(intr)
        d = camera_ray_dirs_dyn(intr, R_flat, rr, cc)
        o = (jnp.broadcast_to(cam_pos[0], rr.shape),
             jnp.broadcast_to(cam_pos[1], rr.shape),
             jnp.broadcast_to(cam_pos[2], rr.shape))
        fb = render_rays(static, settings, params, o, d)
    H, W = intr.height, intr.width
    return FrameBuffers(
        rgb=fb.rgb.reshape(H, W, 3),
        depth=fb.depth.reshape(H, W),
        normal=fb.normal.reshape(H, W, 3),
        hit=fb.hit.reshape(H, W),
        obj_id=fb.obj_id.reshape(H, W),
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _frame_jit(static, intr, settings, params, R_flat, cam_pos):
    return frame_step(static, intr, settings, params, R_flat, cam_pos)


def _pose_arrays(camera):
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    t = np.asarray(camera.position, np.float32)
    return jnp.asarray(R), jnp.asarray(t)


def render_frame(scene, camera, settings: RenderSettings = RenderSettings()
                 ) -> FrameBuffers:
    static, params = scene.freeze()
    params = jax.tree.map(jnp.asarray, params)
    R_flat, cam_pos = _pose_arrays(camera)
    return _frame_jit(static, camera.intrinsics, settings, params,
                      R_flat, cam_pos)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _sequence_jit(static, intr, settings, params, R_flats, cam_positions):
    if settings.backend == "pallas":
        from surfjax.kernels.render_tile import (
            fused_frame_ok, render_sequence_pallas,
        )
        if fused_frame_ok(static):
            # whole animated path in ONE fused pallas call (F x patches
            # grid, per-frame camera rows) — no per-frame dispatch
            return render_sequence_pallas(static, intr, settings, params,
                                          R_flats, cam_positions)
    step = lambda R, t: frame_step(static, intr, settings, params, R, t)
    return jax.vmap(step)(R_flats, cam_positions)


def render_sequence(scene, camera, poses,
                    settings: RenderSettings = RenderSettings()):
    """Batched animated camera path, all frames on-device [BASELINE.json:11].

    poses: (R_flats (F, 9), positions (F, 3)).
    """
    static, params = scene.freeze()
    params = jax.tree.map(jnp.asarray, params)
    R_flats, positions = poses
    return _sequence_jit(static, camera.intrinsics, settings, params,
                         jnp.asarray(R_flats, jnp.float32),
                         jnp.asarray(positions, jnp.float32))
