"""Triangle-mesh engine: uniform-grid traversal + Moller-Trumbore +
barycentric shading (SURVEY.md §2 component 14; BASELINE.json:10).

Host side (`build_grid`): triangles are binned into a uniform voxel grid in
CSR layout (cell_start prefix + flat cell_tris), plus precomputed
Moller-Trumbore edge vectors and area-weighted vertex normals.

Device side (`intersect_mesh`): vectorized Amanatides-Woo DDA over rays —
fixed step budget, per-step gather of a padded per-cell triangle list,
branch-free Moller-Trumbore, hit accepted only within the current cell's
exit t (grid-marching correctness). Gather-heavy (SURVEY.md §7 hard
part 5); the pallas backend replaces it with the packet kernel
(kernels/mesh_tile.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from surfjax.core.math import BIG, F32


class MeshStatic(NamedTuple):
    nx: int
    ny: int
    nz: int
    n_tris: int
    len_cell_tris: int
    k_max: int                 # padded per-step triangle tests
    bbox_min: Tuple[float, float, float]
    cell_size: Tuple[float, float, float]
    smooth: bool


class MeshTables(NamedTuple):
    static: MeshStatic
    arrays: Dict[str, np.ndarray]


def build_grid(mesh, grid_res=None) -> MeshTables:
    """Host-side uniform-grid build over a TriangleMesh (component 14)."""
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)
    F = faces.shape[0]
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    gn = np.cross(e1, e2)  # area-weighted geometric normals
    gl = np.sqrt((gn * gn).sum(-1, keepdims=True))
    gnn = gn / np.maximum(gl, 1e-20)

    # area-weighted vertex normals for barycentric (smooth) shading
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], gn)
    vl = np.sqrt((vn * vn).sum(-1, keepdims=True))
    vn = vn / np.maximum(vl, 1e-20)

    bb_min = verts.min(0)
    bb_max = verts.max(0)
    extent = np.maximum(bb_max - bb_min, 1e-6)
    pad = extent * 1e-3 + 1e-6
    bb_min = bb_min - pad
    bb_max = bb_max + pad
    extent = bb_max - bb_min

    if grid_res is None:
        grid_res = getattr(mesh, "grid_res", None)
    if grid_res is None:
        n = max(int(np.ceil((2.0 * F) ** (1.0 / 3.0))), 1)
        grid_res = (n, n, n)
    nx, ny, nz = (int(v) for v in grid_res)
    cell = extent / np.asarray([nx, ny, nz], np.float32)

    # bin: conservative AABB overlap per triangle. The native C++ builder
    # (surfjax/native) does this at memory speed; the Python loop below is
    # the fallback (identical CSR: same f-ascending order per cell).
    from surfjax.native import grid_bin
    csr = grid_bin(verts, faces, bb_min, cell, nx, ny, nz)
    if csr is not None:
        cell_start, cell_tris = csr
        counts = np.diff(cell_start).astype(np.int32)
    else:
        cells: list = [[] for _ in range(nx * ny * nz)]
        tmin = np.minimum(np.minimum(v0, v1), v2)
        tmax = np.maximum(np.maximum(v0, v1), v2)
        lo = np.clip(((tmin - bb_min) / cell).astype(np.int64), 0,
                     [nx - 1, ny - 1, nz - 1])
        hi = np.clip(((tmax - bb_min) / cell).astype(np.int64), 0,
                     [nx - 1, ny - 1, nz - 1])
        for f in range(F):
            for ix in range(lo[f, 0], hi[f, 0] + 1):
                for iy in range(lo[f, 1], hi[f, 1] + 1):
                    for iz in range(lo[f, 2], hi[f, 2] + 1):
                        cells[(ix * ny + iy) * nz + iz].append(f)
        counts = np.asarray([len(c) for c in cells], np.int32)
        cell_start = np.zeros(len(cells) + 1, np.int32)
        np.cumsum(counts, out=cell_start[1:])
        cell_tris = (np.concatenate([np.asarray(c, np.int32) for c in cells
                                     if c]) if counts.sum() else
                     np.zeros(1, np.int32))
    # every cell's full list must be testable — truncation makes holes
    k_max = int(max(counts.max(), 1))

    # packed per-triangle rows for the Pallas packet kernel
    # (v0, e1, e2, gn, n0, n1, n2, pad) -> (F, 24)
    gn32 = gnn.astype(np.float32)
    vn32 = vn.astype(np.float32)
    tri_packed = np.concatenate(
        [v0, e1, e2, gn32, vn32[faces[:, 0]], vn32[faces[:, 1]],
         vn32[faces[:, 2]], np.zeros((F, 3), np.float32)],
        axis=1).astype(np.float32)

    arrays = {
        "tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
        "tri_n": gn32,
        "vert_n": vn32,
        "faces": faces,
        "verts": verts,
        "cell_start": cell_start,
        "cell_tris": cell_tris,
        "tri_packed": tri_packed,
    }
    static = MeshStatic(nx, ny, nz, F, int(cell_tris.shape[0]), k_max,
                        tuple(float(x) for x in bb_min),
                        tuple(float(x) for x in cell),
                        bool(getattr(mesh, "smooth", True)))
    return MeshTables(static, arrays)


def _mesh_arrays(params, mesh_idx):
    # key format is mesh{i}_{name} where name starts with a letter, so a
    # digit boundary check prevents mesh1_ matching mesh10_* keys
    pre = f"mesh{mesh_idx}_"
    return {k[len(pre):]: v for k, v in params.items()
            if k.startswith(pre) and not k[len(pre)].isdigit()}


def intersect_mesh(ms: MeshStatic, mesh_idx: int, params, o, d,
                   t_min, t_max):
    """Nearest mesh hit for a flat ray batch. Returns (t, tri_id)."""
    a = _mesh_arrays(params, mesh_idx)
    tri_v0, tri_e1, tri_e2 = a["tri_v0"], a["tri_e1"], a["tri_e2"]
    cell_start, cell_tris = a["cell_start"], a["cell_tris"]
    nx, ny, nz = ms.nx, ms.ny, ms.nz
    bmin = ms.bbox_min
    cs = ms.cell_size
    eps = F32(1e-7)

    # ray / grid-AABB clip (slab test)
    t_enter = jnp.full_like(o[0], t_min)
    t_exit = jnp.asarray(t_max, jnp.float32) * jnp.ones_like(o[0])
    for ax in range(3):
        lo = F32(bmin[ax])
        hi = F32(bmin[ax]) + F32(cs[ax]) * F32((nx, ny, nz)[ax])
        dz = d[ax] == F32(0.0)
        inv = F32(1.0) / jnp.where(dz, F32(1.0), d[ax])
        ta = (lo - o[ax]) * inv
        tb = (hi - o[ax]) * inv
        tn = jnp.minimum(ta, tb)
        tf = jnp.maximum(ta, tb)
        in_slab = (o[ax] > lo) & (o[ax] < hi)
        tn = jnp.where(dz, jnp.where(in_slab, -BIG, BIG), tn)
        tf = jnp.where(dz, jnp.where(in_slab, BIG, -BIG), tf)
        t_enter = jnp.maximum(t_enter, tn)
        t_exit = jnp.minimum(t_exit, tf)
    alive0 = t_enter <= t_exit

    # initial cell + DDA state
    t0 = t_enter + F32(1e-5)
    px = o[0] + t0 * d[0]
    py = o[1] + t0 * d[1]
    pz = o[2] + t0 * d[2]

    def cell_of(pc, ax, n):
        c = jnp.floor((pc - F32(bmin[ax])) / F32(cs[ax])).astype(jnp.int32)
        return jnp.clip(c, 0, n - 1)

    ix = cell_of(px, 0, nx)
    iy = cell_of(py, 1, ny)
    iz = cell_of(pz, 2, nz)

    def dda_init(ax, ic):
        dz_ = d[ax] == F32(0.0)
        step = jnp.where(d[ax] > F32(0.0), jnp.int32(1),
                         jnp.where(dz_, jnp.int32(0), jnp.int32(-1)))
        nxt = jnp.where(d[ax] > F32(0.0), ic + 1, ic).astype(jnp.float32)
        bound = F32(bmin[ax]) + nxt * F32(cs[ax])
        inv = F32(1.0) / jnp.where(dz_, F32(1.0), d[ax])
        tmaxa = jnp.where(dz_, BIG, (bound - o[ax]) * inv)
        tdelta = jnp.where(dz_, BIG, jnp.abs(F32(cs[ax]) * inv))
        return step, tmaxa, tdelta

    sx, tmx, tdx = dda_init(0, ix)
    sy, tmy, tdy = dda_init(1, iy)
    sz, tmz, tdz = dda_init(2, iz)

    t_best0 = jnp.full_like(o[0], BIG)
    tri_best0 = jnp.zeros_like(ix)
    max_steps = int(nx + ny + nz + 3)

    def cond(s):
        step, _, _, _, _, _, _, alive, _, _ = s
        return (step < max_steps) & jnp.any(alive)

    def body(s):
        (step, ix, iy, iz, tmx, tmy, tmz, alive, t_best, tri_best) = s
        cid = (ix * ny + iy) * nz + iz
        start = cell_start[cid]
        cnt = cell_start[cid + 1] - start
        # this cell's exit t
        t_cell_exit = jnp.minimum(jnp.minimum(tmx, tmy), tmz)
        for j in range(ms.k_max):
            slot = jnp.clip(start + j, 0, ms.len_cell_tris - 1)
            ti = cell_tris[slot]
            valid = alive & (j < cnt)
            w0 = tri_v0[ti]
            we1 = tri_e1[ti]
            we2 = tri_e2[ti]
            # Moller-Trumbore
            pvx = d[1] * we2[:, 2] - d[2] * we2[:, 1]
            pvy = d[2] * we2[:, 0] - d[0] * we2[:, 2]
            pvz = d[0] * we2[:, 1] - d[1] * we2[:, 0]
            det = (we1[:, 0] * pvx + we1[:, 1] * pvy) + we1[:, 2] * pvz
            ok = jnp.abs(det) > eps
            inv_det = F32(1.0) / jnp.where(ok, det, F32(1.0))
            tvx = o[0] - w0[:, 0]
            tvy = o[1] - w0[:, 1]
            tvz = o[2] - w0[:, 2]
            u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
            qvx = tvy * we1[:, 2] - tvz * we1[:, 1]
            qvy = tvz * we1[:, 0] - tvx * we1[:, 2]
            qvz = tvx * we1[:, 1] - tvy * we1[:, 0]
            v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det
            t = ((we2[:, 0] * qvx + we2[:, 1] * qvy)
                 + we2[:, 2] * qvz) * inv_det
            hit = (valid & ok & (u >= F32(0.0)) & (v >= F32(0.0))
                   & (u + v <= F32(1.0)) & (t > t_min)
                   & (t < jnp.minimum(t_cell_exit + F32(1e-4),
                                      jnp.asarray(t_max, jnp.float32)))
                   & (t < t_best))
            t_best = jnp.where(hit, t, t_best)
            tri_best = jnp.where(hit, ti, tri_best)
        found = t_best < BIG * F32(0.5)
        # step to next cell (axis of smallest tmax)
        x_min = (tmx <= tmy) & (tmx <= tmz)
        y_min = (~x_min) & (tmy <= tmz)
        z_min = (~x_min) & (~y_min)
        ix = jnp.where(alive & x_min, ix + sx, ix)
        iy = jnp.where(alive & y_min, iy + sy, iy)
        iz = jnp.where(alive & z_min, iz + sz, iz)
        tmx = jnp.where(alive & x_min, tmx + tdx, tmx)
        tmy = jnp.where(alive & y_min, tmy + tdy, tmy)
        tmz = jnp.where(alive & z_min, tmz + tdz, tmz)
        inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                  & (iz >= 0) & (iz < nz))
        alive = alive & inside & (~found) & (t_cell_exit < t_exit)
        return (step + 1, ix, iy, iz, tmx, tmy, tmz, alive, t_best,
                tri_best)

    init = (0, ix, iy, iz, tmx, tmy, tmz, alive0, t_best0, tri_best0)
    out = jax.lax.while_loop(cond, body, init)
    t_best, tri_best = out[8], out[9]
    return t_best, tri_best


def mesh_normal(ms: MeshStatic, mesh_idx: int, params, p, tri_id):
    """Shading normal at hit points: barycentric-interpolated vertex
    normals when smooth, geometric otherwise (component 14 'barycentric
    shading')."""
    a = _mesh_arrays(params, mesh_idx)
    if not ms.smooth:
        n = a["tri_n"][tri_id]
        return (n[:, 0], n[:, 1], n[:, 2])
    faces = a["faces"][tri_id]
    v0 = a["tri_v0"][tri_id]
    e1 = a["tri_e1"][tri_id]
    e2 = a["tri_e2"][tri_id]
    # barycentric coords of p in the hit triangle (project onto edges)
    wx = p[0] - v0[:, 0]
    wy = p[1] - v0[:, 1]
    wz = p[2] - v0[:, 2]
    d11 = (e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1]) + e1[:, 2] * e1[:, 2]
    d12 = (e1[:, 0] * e2[:, 0] + e1[:, 1] * e2[:, 1]) + e1[:, 2] * e2[:, 2]
    d22 = (e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1]) + e2[:, 2] * e2[:, 2]
    dw1 = (wx * e1[:, 0] + wy * e1[:, 1]) + wz * e1[:, 2]
    dw2 = (wx * e2[:, 0] + wy * e2[:, 1]) + wz * e2[:, 2]
    denom = d11 * d22 - d12 * d12
    denom = jnp.where(jnp.abs(denom) < F32(1e-20), F32(1e-20), denom)
    u = (d22 * dw1 - d12 * dw2) / denom
    v = (d11 * dw2 - d12 * dw1) / denom
    w = F32(1.0) - u - v
    vn = a["vert_n"]
    n0 = vn[faces[:, 0]]
    n1 = vn[faces[:, 1]]
    n2 = vn[faces[:, 2]]
    nxs = (w * n0[:, 0] + u * n1[:, 0]) + v * n2[:, 0]
    nys = (w * n0[:, 1] + u * n1[:, 1]) + v * n2[:, 1]
    nzs = (w * n0[:, 2] + u * n1[:, 2]) + v * n2[:, 2]
    inv = F32(1.0) / jnp.sqrt((nxs * nxs + nys * nys) + nzs * nzs)
    return (nxs * inv, nys * inv, nzs * inv)
