"""Ring-sharded triangle-mesh intersection (SURVEY.md §5.7 / §2.2 —
the "scene outgrows HBM" extension, the renderer's true ring analogue).

Every SPEC scene fits replicated in HBM, so the default mesh engine
(engines/mesh.py grid DDA, kernels/mesh_tile.py packet kernel) keeps the
whole triangle table on every device. When a mesh does NOT fit, this
module shards the triangle table over the device mesh and streams it:

  - rays stay SHARDED on their devices (each device owns rays/D);
  - triangle shards ROTATE around the device ring via `lax.ppermute`
    (one neighbor hop per step, D steps total) — the ring-attention
    pattern with the scene in the KV role: per-device residency is
    n_tris/D triangles (plus the in-flight shard), and the full mesh
    crosses the device links exactly (D-1)/D times per ray batch, all
    of it neighbor-hop traffic (no all-to-all).

Exactness: the nearest hit is the lexicographic minimum over
(t, global tri id), an associative+commutative reduction, so the order
in which a device sees the shards is irrelevant — results are bitwise
identical to a single-device pass over the full table with the same
Möller–Trumbore arithmetic (asserted in tests/test_ring_mesh.py, which
also pins ring-vs-grid-DDA agreement).

Brute-force per shard (no per-shard grid): the per-device cost is
O(rays/D × n_tris) spread over D pipelined steps. A per-shard uniform
grid composes with the ring unchanged (the reduction is the same) and
is the natural next optimization if a real out-of-HBM workload appears.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from surfjax.core.math import BIG, F32
from surfjax.engines.mesh import MeshTables

_MT_EPS = 1e-7  # same determinant guard as engines/mesh.py::intersect_mesh


def shard_triangles(tables: MeshTables, n_shards: int):
    """Split a built mesh's Möller–Trumbore tables into n_shards equal
    shards (padded with never-hit entries; global ids ride along for the
    exact lexicographic reduction). -> dict of (n_shards, S[, 3]) arrays."""
    a = tables.arrays
    v0 = np.asarray(a["tri_v0"], np.float32)
    e1 = np.asarray(a["tri_e1"], np.float32)
    e2 = np.asarray(a["tri_e2"], np.float32)
    n = v0.shape[0]
    S = -(-n // n_shards)  # ceil
    pad = n_shards * S - n

    def padded(x):
        # degenerate (zero-edge) padding triangles have det == 0 and can
        # never pass the |det| > eps test
        return np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0
        ).reshape(n_shards, S, *x.shape[1:])

    ids = np.concatenate([np.arange(n, dtype=np.int32),
                          np.full(pad, n, np.int32)])
    return {
        "v0": padded(v0), "e1": padded(e1), "e2": padded(e2),
        "ids": ids.reshape(n_shards, S),
        "n_tris": n,
    }


def _mt_shard(o, d, v0, e1, e2, ids, t_min, t_max, t_best, tri_best,
              chunk: int = 64):
    """Fold one triangle shard into the running (t_best, tri_best) for a
    local ray batch. Identical MT arithmetic to engines/mesh.py; the
    accept test adds the id tie-break that makes the reduction exact."""
    S = v0.shape[0]
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3), v0.dtype)], 0)
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)], 0)
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)], 0)
        ids = jnp.concatenate(
            [ids, jnp.full((pad,), jnp.int32(2 ** 30))], 0)
    v0 = v0.reshape(n_chunks, chunk, 3)
    e1 = e1.reshape(n_chunks, chunk, 3)
    e2 = e2.reshape(n_chunks, chunk, 3)
    ids = ids.reshape(n_chunks, chunk)
    tmin = F32(t_min)
    tmax = jnp.asarray(t_max, jnp.float32)

    def body(k, carry):
        t_best, tri_best = carry
        w0 = v0[k]          # (chunk, 3)
        we1 = e1[k]
        we2 = e2[k]
        tid = ids[k]
        # rays (N,1) x tris (1,chunk)
        dx = d[0][:, None]
        dy = d[1][:, None]
        dz = d[2][:, None]
        pvx = dy * we2[None, :, 2] - dz * we2[None, :, 1]
        pvy = dz * we2[None, :, 0] - dx * we2[None, :, 2]
        pvz = dx * we2[None, :, 1] - dy * we2[None, :, 0]
        det = (we1[None, :, 0] * pvx + we1[None, :, 1] * pvy) \
            + we1[None, :, 2] * pvz
        ok = jnp.abs(det) > F32(_MT_EPS)
        inv_det = F32(1.0) / jnp.where(ok, det, F32(1.0))
        tvx = o[0][:, None] - w0[None, :, 0]
        tvy = o[1][:, None] - w0[None, :, 1]
        tvz = o[2][:, None] - w0[None, :, 2]
        u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
        qvx = tvy * we1[None, :, 2] - tvz * we1[None, :, 1]
        qvy = tvz * we1[None, :, 0] - tvx * we1[None, :, 2]
        qvz = tvx * we1[None, :, 1] - tvy * we1[None, :, 0]
        v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det
        t = ((we2[None, :, 0] * qvx + we2[None, :, 1] * qvy)
             + we2[None, :, 2] * qvz) * inv_det
        hit = (ok & (u >= F32(0.0)) & (v >= F32(0.0))
               & (u + v <= F32(1.0)) & (t > tmin) & (t < tmax[:, None]))
        # lexicographic (t, id) running minimum over this chunk
        t_hit = jnp.where(hit, t, BIG)
        id_hit = jnp.where(hit, tid[None, :], jnp.int32(2 ** 30))
        t_c = jnp.min(t_hit, axis=1)
        # argmin with id tie-break: smallest id among tris at t_c
        at_min = t_hit <= t_c[:, None]
        id_c = jnp.min(jnp.where(at_min, id_hit, jnp.int32(2 ** 30)),
                       axis=1)
        better = (t_c < t_best) | ((t_c == t_best) & (id_c < tri_best))
        t_best = jnp.where(better, t_c, t_best)
        tri_best = jnp.where(better, id_c, tri_best)
        return t_best, tri_best

    return jax.lax.fori_loop(0, n_chunks, body, (t_best, tri_best))


@functools.lru_cache(maxsize=32)
def _ring_fn(mesh: Mesh, axis: str, D: int, t_min: float):
    """Compiled ring body, cached on (mesh, axis, D, t_min) so repeated
    ring_trace calls (per-frame batches) reuse the jitted executable —
    jax.jit then caches per ray/shard shape as usual."""

    def body(v0, e1, e2, ids, ox, oy, oz, dx, dy, dz, tmax):
        # per device: v0 (1, S, 3) local shard slice; rays (N/D,)
        v0 = v0[0]
        e1 = e1[0]
        e2 = e2[0]
        ids = ids[0]
        o_l = (ox, oy, oz)
        d_l = (dx, dy, dz)
        t_best = jnp.full_like(ox, BIG)
        # derive from a shard_map input so the carry is varying-tracked
        tri_best = jnp.zeros_like(ox).astype(jnp.int32) + jnp.int32(2 ** 30)
        perm = [(i, (i + 1) % D) for i in range(D)]

        def step(_, carry):
            t_best, tri_best, v0, e1, e2, ids = carry
            t_best, tri_best = _mt_shard(o_l, d_l, v0, e1, e2, ids,
                                         t_min, tmax, t_best, tri_best)
            # rotate the shard one hop around the ring
            v0 = jax.lax.ppermute(v0, axis, perm)
            e1 = jax.lax.ppermute(e1, axis, perm)
            e2 = jax.lax.ppermute(e2, axis, perm)
            ids = jax.lax.ppermute(ids, axis, perm)
            return t_best, tri_best, v0, e1, e2, ids

        t_best, tri_best, *_ = jax.lax.fori_loop(
            0, D, step, (t_best, tri_best, v0, e1, e2, ids))
        return t_best, tri_best

    spec_shard = P(axis)
    spec_ray = P(axis)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec_shard,) * 4 + (spec_ray,) * 7,
        out_specs=(spec_ray, spec_ray))
    return jax.jit(fn)


def ring_trace(shards, o, d, t_min, t_max, mesh: Mesh,
               axis: str = "shard"):
    """Nearest mesh hit over a device ring. `shards` from
    shard_triangles(n_shards = mesh.shape[axis]); rays (flat f32
    triples) must have length divisible by the ring size. Returns
    (t, tri_id) gathered on the host: t == BIG and tri_id == n_tris on
    miss. Bitwise equal to a single-device full-table pass.

    The compiled executable is cached on (mesh, axis, ring size, t_min)
    + shapes; device_put with an array's existing NamedSharding is a
    no-op, so pre-placed shard tables transfer once across repeated
    per-batch calls."""
    D = mesh.shape[axis]
    n_tris = shards["n_tris"]
    fn = _ring_fn(mesh, axis, D, float(t_min))
    dev = lambda x, s: jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, s))
    tmax_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                o[0].shape)
    t, tri = fn(
        dev(shards["v0"], spec := P(axis)), dev(shards["e1"], spec),
        dev(shards["e2"], spec), dev(shards["ids"], spec),
        dev(o[0], spec), dev(o[1], spec), dev(o[2], spec),
        dev(d[0], spec), dev(d[1], spec), dev(d[2], spec),
        dev(tmax_arr, spec))
    tri = jnp.where(t < BIG * F32(0.5), tri, jnp.int32(n_tris))
    return t, tri
