"""Analytic intersection engine: quadric/slab interval hits + exact CSG.

SURVEY.md §2 components 4 (quadric hit engine) and 7 (CSG combinators),
BASELINE.json:5 "analytic quadric hits", :8 "CSG union/intersect".

Design (branch-free): each convex leaf (sphere, halfspace plane,
AAbox) contributes one entry/exit interval [t0, t1] along the ray (empty =
(+BIG, -BIG)). The CSG solid's surface events are exactly the leaf interval
endpoints, so the nearest CSG hit is found *without interval-list algebra*:
for each of the 2·n_leaves candidate endpoints, evaluate the (statically
unrolled) boolean CSG tape on the per-leaf inside-statuses with the event's
leaf set to its before/after state; the event is a surface of the solid iff
the tree value flips. Fully vectorized over rays, fixed shapes, no
data-dependent control flow — exactly what XLA/Pallas want.

Everything is float32 with the fixed evaluation order shared with the golden
renderer (surfjax/golden/renderer.py implements the same algorithm
independently in NumPy).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from surfjax.core.math import (
    BIG, F32, quadratic_smallest_root, vdot, vnormalize, vsub,
)
from surfjax.core.scene_compile import (
    LEAF_BOX, LEAF_PLANE, LEAF_SPHERE, ObjectIR,
)
from surfjax.api import (
    OP_LEAF, OP_UNION, OP_INTERSECT, OP_SUBTRACT,
)


def leaf_interval(kind: int, prm, o, d):
    """Entry/exit interval of one convex leaf. prm: (LEAF_PARAM_W,) row.

    Returns (t0, t1) arrays shaped like the ray batch. Empty: (BIG, -BIG).
    """
    if kind == LEAF_SPHERE:
        c = (prm[0], prm[1], prm[2])
        r = prm[3]
        oc = vsub(o, c)
        b = vdot(oc, d)
        cc = vdot(oc, oc) - r * r
        t0, t1, _ = quadratic_smallest_root(b, cc)
        return t0, t1
    if kind == LEAF_PLANE:
        n = (prm[0], prm[1], prm[2])
        off = prm[3]
        denom = vdot(n, d)
        no = vdot(n, o)
        safe = jnp.where(denom == F32(0.0), F32(1.0), denom)
        t_star = (off - no) / safe
        inside = (no - off) < F32(0.0)
        t0 = jnp.where(denom < F32(0.0), t_star, -BIG)
        t1 = jnp.where(denom < F32(0.0), BIG, t_star)
        t0 = jnp.where(denom == F32(0.0), jnp.where(inside, -BIG, BIG), t0)
        t1 = jnp.where(denom == F32(0.0), jnp.where(inside, BIG, -BIG), t1)
        return t0, t1
    if kind == LEAF_BOX:
        c = (prm[0], prm[1], prm[2])
        h = (prm[3], prm[4], prm[5])
        t0 = jnp.full_like(o[0], -BIG)
        t1 = jnp.full_like(o[0], BIG)
        for ax in range(3):
            dz = d[ax] == F32(0.0)
            safe = jnp.where(dz, F32(1.0), d[ax])
            inv = F32(1.0) / safe
            lo = (c[ax] - h[ax] - o[ax]) * inv
            hi = (c[ax] + h[ax] - o[ax]) * inv
            tn = jnp.minimum(lo, hi)
            tf = jnp.maximum(lo, hi)
            # d==0: ray parallel to slab; inside slab -> (-BIG, BIG) else empty
            in_slab = jnp.abs(o[ax] - c[ax]) <= h[ax]
            tn = jnp.where(dz, jnp.where(in_slab, -BIG, BIG), tn)
            tf = jnp.where(dz, jnp.where(in_slab, BIG, -BIG), tf)
            t0 = jnp.maximum(t0, tn)
            t1 = jnp.minimum(t1, tf)
        empty = t0 > t1
        t0 = jnp.where(empty, BIG, t0)
        t1 = jnp.where(empty, -BIG, t1)
        return t0, t1
    raise ValueError(f"analytic engine: unsupported leaf kind {kind}")


def _eval_tree(oir: ObjectIR, statuses):
    """Boolean CSG tape over per-leaf inside statuses. Statically unrolled."""
    vals = []
    for nd in oir.nodes:
        if nd.op == OP_LEAF:
            vals.append(statuses[nd.leaf])
        elif nd.op == OP_UNION:
            vals.append(vals[nd.a] | vals[nd.b])
        elif nd.op == OP_INTERSECT:
            vals.append(vals[nd.a] & vals[nd.b])
        elif nd.op == OP_SUBTRACT:
            vals.append(vals[nd.a] & (~vals[nd.b]))
        else:
            raise ValueError("smooth CSG op reached the analytic engine")
    return vals[-1]


def intersect_analytic(oir: ObjectIR, leaf_params, o, d, t_min, t_max):
    """Nearest hit of one analytic CSG object for a batch of rays.

    Returns (t, leaf_local_id). Miss: (BIG, 0).
    """
    n_leaves = len(oir.leaves)
    intervals = []
    for lf in oir.leaves:
        prm = leaf_params[lf.slot]
        intervals.append(leaf_interval(lf.kind, prm, o, d))

    if n_leaves == 1 and len(oir.nodes) == 1:
        # fast path: single convex leaf — nearest boundary in range
        t0, t1 = intervals[0]
        e0 = (t0 > t_min) & (t0 < t_max)
        e1 = (t1 > t_min) & (t1 < t_max)
        t = jnp.where(e0, t0, jnp.where(e1, t1, BIG))
        return t, jnp.zeros_like(t, jnp.int32)

    t_best = jnp.full_like(o[0], BIG)
    leaf_best = jnp.zeros_like(o[0], dtype=jnp.int32)
    for li in range(n_leaves):
        for endpoint in range(2):
            t_e = intervals[li][endpoint]
            statuses_before = []
            statuses_after = []
            for lj in range(n_leaves):
                if lj == li:
                    # entry event (endpoint 0): outside -> inside
                    # exit event (endpoint 1): inside -> outside
                    before = endpoint == 1
                    shaped = jnp.full_like(t_e, before, dtype=bool)
                    statuses_before.append(shaped)
                    statuses_after.append(~shaped)
                else:
                    tj0, tj1 = intervals[lj]
                    inside_j = (tj0 < t_e) & (t_e < tj1)
                    statuses_before.append(inside_j)
                    statuses_after.append(inside_j)
            flip = _eval_tree(oir, statuses_before) ^ _eval_tree(
                oir, statuses_after)
            valid = flip & (t_e > t_min) & (t_e < t_max)
            better = valid & (t_e < t_best)
            t_best = jnp.where(better, t_e, t_best)
            leaf_best = jnp.where(better, jnp.int32(li), leaf_best)
    return t_best, leaf_best


def leaf_normal(kind: int, prm, p):
    """Outward analytic normal of a leaf at surface point p (component 8)."""
    if kind == LEAF_SPHERE:
        c = (prm[0], prm[1], prm[2])
        return vnormalize(vsub(p, c))
    if kind == LEAF_PLANE:
        shaped = jnp.ones_like(p[0])
        return (prm[0] * shaped, prm[1] * shaped, prm[2] * shaped)
    if kind == LEAF_BOX:
        c = (prm[0], prm[1], prm[2])
        h = (prm[3], prm[4], prm[5])
        q = vsub(p, c)
        # distance of |q| to each face plane; the max selects the hit face
        dx = jnp.abs(q[0]) - h[0]
        dy = jnp.abs(q[1]) - h[1]
        dz = jnp.abs(q[2]) - h[2]
        sx = jnp.where(q[0] >= F32(0.0), F32(1.0), F32(-1.0))
        sy = jnp.where(q[1] >= F32(0.0), F32(1.0), F32(-1.0))
        sz = jnp.where(q[2] >= F32(0.0), F32(1.0), F32(-1.0))
        x_wins = (dx >= dy) & (dx >= dz)
        y_wins = (~x_wins) & (dy >= dz)
        zero = jnp.zeros_like(dx)
        nx = jnp.where(x_wins, sx, zero)
        ny = jnp.where(y_wins, sy, zero)
        nz = jnp.where(x_wins | y_wins, zero, sz)
        return (nx, ny, nz)
    raise ValueError(f"analytic normal: unsupported leaf kind {kind}")


def object_normal_analytic(oir: ObjectIR, leaf_params, p, leaf_id):
    """Normal of an analytic CSG object given the winning leaf id.

    Applies the static SUBTRACT-parity sign baked into LeafIR.sign.
    """
    nx = jnp.zeros_like(p[0])
    ny = jnp.zeros_like(p[0])
    nz = jnp.zeros_like(p[0])
    for li, lf in enumerate(oir.leaves):
        n = leaf_normal(lf.kind, leaf_params[lf.slot], p)
        s = F32(float(lf.sign))
        sel = leaf_id == jnp.int32(li)
        nx = jnp.where(sel, n[0] * s, nx)
        ny = jnp.where(sel, n[1] * s, ny)
        nz = jnp.where(sel, n[2] * s, nz)
    return (nx, ny, nz)
