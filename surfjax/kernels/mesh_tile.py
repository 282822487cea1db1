"""Packet (per-tile) triangle-mesh intersection for the Pallas backend.

The grid-DDA traversal (engines/mesh.py) is correct everywhere, but it
runs as one while loop over the whole ray batch with k_max candidate
gathers per cell step. The packet design instead tests each tile's
candidate list inside one kernel block:

  1. XLA side, per frame: clip every ray to the mesh AABB; each
     candidate tile's frustum is the AABB of its lanes' entry/exit
     segment endpoints (exact for line segments, hence conservative for
     the tile), refined by three oriented separating axes. Candidate
     triangles are compacted to a padded (tiles, K) index table by a
     prefix-sum scatter; candidate data is one row-gather of the packed
     triangle table.
  2. Pallas kernel (Triton route), one program per tile_rows x 128 ray
     block: a loop over its tile's candidates with scalar reads of each
     candidate row — branch-free Moller-Trumbore over the block,
     capturing the winning triangle's geometric normal and
     barycentric-interpolated vertex normals in-loop (no post-hoc
     gathers). Tiles whose candidate count overflows K scan the full
     packed table instead (selected by lax.cond outside the kernel, read
     from device memory) — correctness never depends on K.

A candidate tile spans CAND_ROWS rows of 128 rays, so several ray blocks
share one candidate list. Candidate sets are conservative, so results
equal brute-force/grid-DDA nearest hits exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from surfjax.core.math import BIG, F32
from surfjax.core.types import RenderSettings
from surfjax.engines.mesh import MeshStatic
from surfjax.kernels.render_tile import LANES, _pallas

PACKET_K = 1024  # candidate budget per tile; overflow -> full-table scan
# Rows of 128 rays per candidate tile (a multiple of every tile_rows):
# larger tiles mean fewer, longer candidate lists.
CAND_ROWS = 16
# Triangle tests per loop trip. Substeps past the valid count are masked
# off (clamped reads, hit &= k < n) so any unroll value is value-exact;
# a larger unroll means fewer all-done reductions on the any-hit path and
# more code. Not yet swept on the GPU (PERF.md, open questions).
MESH_UNROLL = 4


def mesh_candidates(ms: MeshStatic, tri_packed, o2, d2, t_min, t_max,
                    tile_rows: int, K: int = PACKET_K):
    """-> (cand_data (tiles, K, 24), counts (tiles,) i32).

    Conservative per-tile candidate sets via segment-AABB culling.
    """
    rows, lanes = o2[0].shape
    tiles = rows // tile_rows
    bmin = jnp.asarray(ms.bbox_min, jnp.float32)
    bext = jnp.asarray([ms.cell_size[0] * ms.nx, ms.cell_size[1] * ms.ny,
                        ms.cell_size[2] * ms.nz], jnp.float32)
    bmax = bmin + bext

    # per-lane ray/bbox clip (slab)
    t_lo = jnp.full_like(o2[0], t_min)
    t_hi = jnp.asarray(t_max, jnp.float32) * jnp.ones_like(o2[0])
    for ax in range(3):
        dz = d2[ax] == F32(0.0)
        inv = F32(1.0) / jnp.where(dz, F32(1.0), d2[ax])
        ta = (bmin[ax] - o2[ax]) * inv
        tb = (bmax[ax] - o2[ax]) * inv
        tn = jnp.minimum(ta, tb)
        tf = jnp.maximum(ta, tb)
        in_slab = (o2[ax] > bmin[ax]) & (o2[ax] < bmax[ax])
        tn = jnp.where(dz, jnp.where(in_slab, -BIG, BIG), tn)
        tf = jnp.where(dz, jnp.where(in_slab, BIG, -BIG), tf)
        t_lo = jnp.maximum(t_lo, tn)
        t_hi = jnp.minimum(t_hi, tf)
    valid = t_lo <= t_hi

    # segment endpoints; invalid lanes contribute empty AABBs
    pa = [o2[ax] + t_lo * d2[ax] for ax in range(3)]
    pb = [o2[ax] + t_hi * d2[ax] for ax in range(3)]

    def tile_range(a_lane, b_lane):
        lo = jnp.minimum(a_lane, b_lane)
        hi = jnp.maximum(a_lane, b_lane)
        lo = jnp.where(valid, lo, BIG)
        hi = jnp.where(valid, hi, -BIG)
        lo = lo.reshape(tiles, tile_rows * lanes).min(axis=1)
        hi = hi.reshape(tiles, tile_rows * lanes).max(axis=1)
        return lo, hi

    tlo = []
    thi = []
    for ax in range(3):
        lo, hi = tile_range(pa[ax], pb[ax])
        tlo.append(lo)
        thi.append(hi)

    # triangle AABBs (F, 3) lo/hi from packed v0/e1/e2
    v0 = tri_packed[:, 0:3]
    p1 = v0 + tri_packed[:, 3:6]
    p2 = v0 + tri_packed[:, 6:9]
    tri_lo = jnp.minimum(jnp.minimum(v0, p1), p2)
    tri_hi = jnp.maximum(jnp.maximum(v0, p1), p2)

    eps = F32(1e-4)
    overlap = jnp.ones((tiles, tri_packed.shape[0]), bool)
    for ax in range(3):
        overlap = overlap & (tri_lo[None, :, ax] <= thi[ax][:, None] + eps)
        overlap = overlap & (tri_hi[None, :, ax] >= tlo[ax][:, None] - eps)

    # Oriented (k-DOP) refinement: axis-aligned boxes are weak for long
    # diagonal segment bundles (shadow cones toward a point light sweep
    # the whole mesh AABB). Three per-tile separating axes — the mean
    # segment direction and two orthogonals — projected by matmul (no
    # gathers). Separating-axis logic is conservative: the segments'
    # projections lie inside the endpoints' projection hull, so a
    # disjoint range proves no segment can touch the triangle.
    dsum = [jnp.where(valid, d2[ax], F32(0.0))
            .reshape(tiles, tile_rows * lanes).sum(axis=1)
            for ax in range(3)]
    nrm = jnp.sqrt(dsum[0] ** 2 + dsum[1] ** 2 + dsum[2] ** 2)
    ok = nrm > F32(1e-6)
    w = jnp.stack([jnp.where(ok, dsum[ax] / jnp.where(ok, nrm, F32(1.0)),
                             F32(1.0) if ax == 0 else F32(0.0))
                   for ax in range(3)], axis=1)              # (tiles, 3)
    # orthonormal complement (branch-free reference-vector pick)
    ref = jnp.where(jnp.abs(w[:, 1:2]) < F32(0.9),
                    jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
                    jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32))
    u = jnp.cross(w, ref)
    u = u / jnp.linalg.norm(u, axis=1, keepdims=True)
    v = jnp.cross(w, u)
    axes = jnp.stack([w, u, v], axis=1)                      # (tiles, 3, 3)
    verts = jnp.stack([v0, p1, p2], axis=0)                  # (3, F, 3)
    for k in range(3):
        a = axes[:, k, :]                                    # (tiles, 3)
        # HIGHEST precision is load-bearing: a float32 matmul on the GPU
        # defaults to TF32 (10-bit mantissa, ~1e-3 rel error on O(1-10)
        # coords), which can shrink a triangle's projected range past
        # the 1e-4 eps and cull a truly-hit triangle — the same failure
        # class as a bf16 product, which once dropped a near hit on 118
        # c4 pixels (depth 2.16 -> 3.91). The segment side (sa/sb) is
        # elementwise f32, so both sides must round alike.
        tproj = jnp.einsum("tc,vfc->tvf", a, verts,
                           precision=jax.lax.Precision.HIGHEST)
        tpro_lo = tproj.min(axis=1)
        tpro_hi = tproj.max(axis=1)
        sa = sum(pa[ax].reshape(tiles, -1) * a[:, ax:ax + 1]
                 for ax in range(3))
        sb = sum(pb[ax].reshape(tiles, -1) * a[:, ax:ax + 1]
                 for ax in range(3))
        slo, shi = tile_range(sa.reshape(o2[0].shape),
                              sb.reshape(o2[0].shape))
        overlap = overlap & (tpro_lo <= shi[:, None] + eps)
        overlap = overlap & (tpro_hi >= slo[:, None] - eps)

    counts = overlap.sum(axis=1).astype(jnp.int32)
    # compaction: candidate f of tile t goes to slot cum[t, f] - 1;
    # non-candidates and slots past K (overflow tiles) are dropped
    F_n = tri_packed.shape[0]
    cum = jnp.cumsum(overlap.astype(jnp.int32), axis=1)
    slot = jnp.where(overlap, cum - 1, K)
    cand_ids = jnp.zeros((tiles, K), jnp.int32).at[
        jnp.arange(tiles, dtype=jnp.int32)[:, None], slot].set(
        jnp.broadcast_to(jnp.arange(F_n, dtype=jnp.int32)[None, :],
                         slot.shape), mode="drop")  # slots >= count unused
    cand_data = tri_packed[cand_ids]
    return cand_data, counts


def _mesh_body(settings, smooth: bool, any_hit: bool, with_full: bool,
               blocks_per_tile: int, *refs):
    if with_full:
        (counts_ref, cand_ref, full_ref,
         ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
         t_ref, nsx_ref, nsy_ref, nsz_ref, ngx_ref, ngy_ref,
         ngz_ref) = refs
    else:
        # no-overflow variant: when no tile overflows K the caller
        # selects this kernel (lax.cond) and no block carries the
        # full-table branch
        (counts_ref, cand_ref,
         ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
         t_ref, nsx_ref, nsy_ref, nsz_ref, ngx_ref, ngy_ref,
         ngz_ref) = refs
        full_ref = None
    count = counts_ref[pl.program_id(0) // blocks_per_tile]
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t_maxv = tmax_ref[...]
    eps = F32(1e-7)
    t_min = F32(settings.t_min if not any_hit else settings.shadow_eps)

    def make_step(ref, is_cand, n_cap, n_valid):
        """Guarded per-triangle test: reads clamp to n_cap-1 rows and a
        test at k >= n_valid is masked off, so unrolled trips may run
        past the valid count with no effect (value-exact)."""
        def body(k, carry):
            t_best, nsx, nsy, nsz, ngx, ngy, ngz = carry
            kc = jnp.minimum(k, n_cap - 1)
            if is_cand:
                row = lambda j: ref[0, kc, j]
            else:
                row = lambda j: ref[kc, j]
            v0 = (row(0), row(1), row(2))
            e1 = (row(3), row(4), row(5))
            e2 = (row(6), row(7), row(8))
            # Moller-Trumbore, branch-free on the whole tile
            pvx = d[1] * e2[2] - d[2] * e2[1]
            pvy = d[2] * e2[0] - d[0] * e2[2]
            pvz = d[0] * e2[1] - d[1] * e2[0]
            det = (e1[0] * pvx + e1[1] * pvy) + e1[2] * pvz
            ok = jnp.abs(det) > eps
            inv_det = F32(1.0) / jnp.where(ok, det, F32(1.0))
            tvx = o[0] - v0[0]
            tvy = o[1] - v0[1]
            tvz = o[2] - v0[2]
            u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
            qvx = tvy * e1[2] - tvz * e1[1]
            qvy = tvz * e1[0] - tvx * e1[2]
            qvz = tvx * e1[1] - tvy * e1[0]
            v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det
            t = ((e2[0] * qvx + e2[1] * qvy) + e2[2] * qvz) * inv_det
            hit = (ok & (u >= F32(0.0)) & (v >= F32(0.0))
                   & (u + v <= F32(1.0)) & (t > t_min) & (t < t_maxv)
                   & (t < t_best) & (k < n_valid))
            if not any_hit:
                gn = (row(9), row(10), row(11))
                if smooth:
                    n0 = (row(12), row(13), row(14))
                    n1 = (row(15), row(16), row(17))
                    n2 = (row(18), row(19), row(20))
                    w = F32(1.0) - u - v
                    sx = (w * n0[0] + u * n1[0]) + v * n2[0]
                    sy = (w * n0[1] + u * n1[1]) + v * n2[1]
                    sz = (w * n0[2] + u * n1[2]) + v * n2[2]
                    inv = F32(1.0) / jnp.sqrt((sx * sx + sy * sy) + sz * sz)
                    sx, sy, sz = sx * inv, sy * inv, sz * inv
                else:
                    sx = gn[0] * jnp.ones_like(u)
                    sy = gn[1] * jnp.ones_like(u)
                    sz = gn[2] * jnp.ones_like(u)
                nsx = jnp.where(hit, sx, nsx)
                nsy = jnp.where(hit, sy, nsy)
                nsz = jnp.where(hit, sz, nsz)
                ngx = jnp.where(hit, gn[0], ngx)
                ngy = jnp.where(hit, gn[1], ngy)
                ngz = jnp.where(hit, gn[2], ngz)
            t_best = jnp.where(hit, t, t_best)
            return t_best, nsx, nsy, nsz, ngx, ngy, ngz
        return body

    z = jnp.zeros_like(o[0])
    init = (jnp.full_like(o[0], BIG), z, z, jnp.ones_like(o[0]),
            z, z, jnp.ones_like(o[0]))

    n_full = full_ref.shape[0] if full_ref is not None else 0
    K = cand_ref.shape[1]

    if any_hit:
        # any-hit wants the first occlusion, not the nearest: exit the
        # scan once every lane has found a hit or was inactive (miss
        # lanes carry t_maxv <= t_min). f32 done mask: the block-wide
        # test is a float min reduction.
        # MESH_UNROLL guarded tests per trip; the trip may record up to
        # MESH_UNROLL-1 extra (nearer) occluders after the last lane's
        # first hit — the occlusion BOOLEAN the caller consumes is
        # unchanged (once occluded, stays occluded).
        inactive = jnp.where(t_maxv <= t_min, F32(1.0), F32(0.0))

        def scan_any(ref, is_cand, n_cap, n):
            body = make_step(ref, is_cand, n_cap, n)

            def cond(s):
                k, carry = s
                done = jnp.maximum(
                    inactive,
                    jnp.where(carry[0] < BIG * F32(0.5), F32(1.0),
                              F32(0.0)))
                return (k < n) & (jnp.min(done) < F32(0.5))

            def step(s):
                k, carry = s
                for u in range(MESH_UNROLL):
                    carry = body(k + u, carry)
                return k + MESH_UNROLL, carry

            _, carry = jax.lax.while_loop(cond, step, (0, init))
            return carry

        if full_ref is None:
            out = scan_any(cand_ref, True, K, jnp.minimum(count, K))
        else:
            out = jax.lax.cond(
                count > K,
                lambda: scan_any(full_ref, False, n_full, n_full),
                lambda: scan_any(cand_ref, True, K,
                                 jnp.minimum(count, K)))
    else:
        def run_chunked(ref, is_cand, n_cap, n):
            # ceil(n / MESH_UNROLL) trips of guarded substeps: identical
            # triangle visit order, 1/MESH_UNROLL the carry traffic
            body = make_step(ref, is_cand, n_cap, n)
            trips = (n + MESH_UNROLL - 1) // MESH_UNROLL

            def chunk(c, carry):
                for u in range(MESH_UNROLL):
                    carry = body(c * MESH_UNROLL + u, carry)
                return carry

            return jax.lax.fori_loop(0, trips, chunk, init)

        def cand_path():
            return run_chunked(cand_ref, True, K, jnp.minimum(count, K))

        if full_ref is None:
            out = cand_path()
        else:
            def full_path():
                return run_chunked(full_ref, False, n_full, n_full)

            out = jax.lax.cond(count > K, full_path, cand_path)
    t_best, nsx, nsy, nsz, ngx, ngy, ngz = out
    t_ref[...] = t_best
    nsx_ref[...] = nsx
    nsy_ref[...] = nsy
    nsz_ref[...] = nsz
    ngx_ref[...] = ngx
    ngy_ref[...] = ngy
    ngz_ref[...] = ngz


def mesh_tile_kernel(ms: MeshStatic, settings: RenderSettings, tri_packed,
                     o2, d2, t_max, any_hit: bool = False):
    """Packet mesh intersection over (rows, 128)-tiled rays.

    Returns (t (rows,128), n_shade(3), n_geom(3)); t == BIG on miss.
    t_max may be a per-lane array (shadow distance).
    """
    rows = o2[0].shape[0]
    R = settings.tile_rows
    C = max(CAND_ROWS, R)
    pad = -rows % C
    t_maxv = jnp.asarray(t_max, jnp.float32) * jnp.ones_like(o2[0])
    rays = [jnp.pad(a, ((0, pad), (0, 0)), mode="edge")
            for a in (*o2, *d2, t_maxv)]
    rows_p = rows + pad
    # candidate segments must start where the in-kernel accept test does:
    # shadow (any-hit) rays accept from shadow_eps, not t_min — culling
    # from t_min would drop contact occluders in (shadow_eps, t_min)
    # whenever a config raises t_min (review r3)
    t_seg_min = settings.shadow_eps if any_hit else settings.t_min
    cand, counts = mesh_candidates(ms, tri_packed, rays[:3], rays[3:6],
                                   t_seg_min, rays[6], C, K=PACKET_K)
    G = C // R   # ray blocks per candidate tile

    shp = jax.ShapeDtypeStruct((rows_p, LANES), jnp.float32)
    ray_spec = pl.BlockSpec((R, LANES), lambda i: (i, 0))
    base_specs = [
        pl.BlockSpec(),                                        # counts
        pl.BlockSpec((1, cand.shape[1], cand.shape[2]),
                     lambda i: (i // G, 0, 0)),               # candidates
    ]

    def call(with_full: bool):
        body = functools.partial(_mesh_body, settings, ms.smooth, any_hit,
                                 with_full, G)
        full_spec = [pl.BlockSpec()] if with_full else []
        full_arg = (tri_packed,) if with_full else ()
        return _pallas(
            body,
            grid=(rows_p // R,),
            in_specs=base_specs + full_spec + [ray_spec] * 7,
            out_specs=(ray_spec,) * 7,
            out_shape=(shp,) * 7, tile_rows=R,
        )(counts, cand, *full_arg, *rays)

    K = cand.shape[1]
    if tri_packed.shape[0] <= K:
        out = call(False)  # overflow impossible
    else:
        # select the no-table kernel at runtime whenever no tile exceeds
        # K (overflow is rare after the oriented-axis culling)
        out = jax.lax.cond(jnp.any(counts > jnp.int32(K)),
                           lambda: call(True), lambda: call(False))
    t, nsx, nsy, nsz, ngx, ngy, ngz = (a[:rows] for a in out)
    return t, (nsx, nsy, nsz), (ngx, ngy, ngz)
