#!/usr/bin/env python
"""Generate the canonical power-8 Mandelbulb lobe-sphere cover
(surfjax/engines/bulb_lobes.py).

The single whole-bulb bounding sphere (radius 1.3 canonical) admits every
ray through its silhouette into the full-DE march. The bulb's lobe
structure is static in CANONICAL space (unit scale, origin center), so a
fixed set of K spheres covering the hit region can be precomputed once
and transformed by (center, scale) at trace time — VERDICT r2 items 1b/5.

OUTCOME (r3, measured — the runtime integration was built, measured and
REVERTED; this tool is kept as the record): {DE_8 < 0.08} fills ~84% of
the 1.2-ball (7.8M/23.9M cells at N=288) — the bulb is a solid blob
whose lobes are surface corrugation, so 0.0% of silhouette rays miss an
80-sphere validated cover and nothing can skip "between lobes", so the
tighter entry/exit (effective silhouette ~1.25 vs 1.38) saves almost no
march steps while the 80-sphere closed-form entry adds work to every
ray.

Soundness target (the only property the primary-march entry/exit gating
needs): for every runtime hit threshold e <= TAU_RUN,

        { p : DE_8(p) < e }  is contained in  UNION_j sphere_j

at the DEFAULT full iteration count 8 (the primary march always
evaluates the object's full p1; the LoD-truncated DEs are used only by
shadow/AO marches, which do NOT use the lobe gating — they keep the
single whole-bulb bound). Runtime gates statically on power==8 and
iterations==8 and falls back to the single bound otherwise.

Construction: {DE_8 < TAU_BUILD} on an N^3 grid, k-means sphere cover of
the region cells, radii inflated by (cell diagonal + MARGIN), then
validated on dense random samples: every sample with DE_8 < TAU_RUN must
lie inside the cover with positive depth; the minimum observed depth is
reported. The validation is empirical-with-margin — the same standard as
the existing whole-bulb 1.3-radius bound (engines' set-radius-1.25 claim
+ 0.05 margin), and the repo's bitwise kernel-vs-twin and full-res
golden tests exercise the gating end-to-end on real scenes.

Usage: python tools/gen_lobe_bounds.py [N] [K]  (defaults 288, 80)
Writes the table to stdout; paste into surfjax/engines/bulb_lobes.py.
"""

from __future__ import annotations

import sys

import numpy as np

F = np.float32

TAU_BUILD = 0.08
TAU_RUN = 0.05
MARGIN = 0.02
ITERATIONS = 8
BAILOUT = 2.0


def canonical_de(p, iterations: int):
    """Power-8 trigless DE, canonical (center 0, scale 1, bailout 2).
    Mirrors engines/sdf.py::sdf_mandelbulb (f32, same guard)."""
    px, py, pz = (a.astype(np.float32) for a in p)
    bailout2 = F(BAILOUT) * F(BAILOUT) * F(16.0)
    wx, wy, wz = px.copy(), py.copy(), pz.copy()
    m = (wx * wx + wy * wy) + wz * wz
    dz = np.ones_like(m)
    escaped = m > bailout2
    tiny = F(1e-4)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(iterations):
            active = ~escaped
            m2 = m * m
            m4 = m2 * m2
            dz_new = F(8.0) * np.sqrt((m4 * m2) * m) * dz + F(1.0)
            x, y, z = wx, wy, wz
            x2 = x * x
            x4 = x2 * x2
            y2 = y * y
            y4 = y2 * y2
            z2 = z * z
            z4 = z2 * z2
            k3 = x2 + z2
            k3s = np.maximum(k3, tiny)
            k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
            k2 = F(1.0) / np.sqrt(k37)
            k1 = ((x4 + y4) + z4) - F(6.0) * (y2 * z2) \
                - F(6.0) * (x2 * y2) + F(2.0) * (z2 * x2)
            k4 = (x2 - y2) + z2
            wx_new = px + F(64.0) * ((((x * y) * z) * (x2 - z2)) * k4) \
                * ((x4 - F(6.0) * (x2 * z2)) + z4) * k1 * k2
            wy_new = py + (F(-16.0) * (y2 * k3) * (k4 * k4) + k1 * k1)
            wz_new = pz + F(-8.0) * (y * k4) \
                * ((((x4 * x4) - F(28.0) * ((x4 * x2) * z2))
                    + F(70.0) * (x4 * z4))
                   - F(28.0) * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2
            wx = np.where(active, wx_new, wx)
            wy = np.where(active, wy_new, wy)
            wz = np.where(active, wz_new, wz)
            dz = np.where(active, dz_new, dz)
            m = np.where(active, (wx * wx + wy * wy) + wz * wz, m)
            escaped = escaped | (m > bailout2)
    r = np.sqrt(m)
    de = F(0.25) * np.log(m) * r / dz
    r0 = np.sqrt((px * px + py * py) + pz * pz)
    far = r0 - F(1.35)
    return np.where(far > F(0.0), np.minimum(de, far + F(0.1)), de)


def min_de(p):
    return canonical_de(p, ITERATIONS)


def kmeans_cover(pts, K: int, iters: int = 40, seed: int = 0):
    """Furthest-point-seeded Lloyd k-means; returns (centers, radii)."""
    rng = np.random.default_rng(seed)
    # furthest-point seeding for even coverage
    centers = [pts[rng.integers(len(pts))]]
    d2 = ((pts - centers[0]) ** 2).sum(1)
    for _ in range(K - 1):
        centers.append(pts[int(np.argmax(d2))])
        d2 = np.minimum(d2, ((pts - centers[-1]) ** 2).sum(1))
    C = np.stack(centers)
    for _ in range(iters):
        d2 = ((pts[:, None, :] - C[None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(1)
        for k in range(K):
            sel = lab == k
            if sel.any():
                C[k] = pts[sel].mean(0)
    d2 = ((pts[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    lab = d2.argmin(1)
    R = np.zeros(K, np.float64)
    for k in range(K):
        sel = lab == k
        if sel.any():
            R[k] = np.sqrt(((pts[sel] - C[k]) ** 2).sum(1)).max()
    keep = R > 0
    return C[keep], R[keep]


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 288
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 80
    lo, hi = -1.32, 1.32
    h = (hi - lo) / (N - 1)
    diag = h * np.sqrt(3.0)
    ax = np.linspace(lo, hi, N, dtype=np.float32)

    # grid minDE, sliced to bound memory
    print(f"# grid N={N} h={h:.4f} ...", file=sys.stderr)
    vals = np.empty((N, N, N), np.float32)
    Y, Z = np.meshgrid(ax, ax, indexing="ij")
    for i, x in enumerate(ax):
        X = np.full_like(Y, x)
        vals[i] = min_de((X, Y, Z))

    T = vals < F(TAU_BUILD)
    ii, jj, kk = np.nonzero(T)
    pts = np.stack([ax[ii], ax[jj], ax[kk]], axis=1).astype(np.float64)
    print(f"# region cells: {len(pts)} ({len(pts)/vals.size*100:.2f}%)",
          file=sys.stderr)

    # subsample for k-means speed, cover radii computed on ALL points
    sub = pts[np.random.default_rng(1).permutation(len(pts))[:60000]]
    C, _ = kmeans_cover(sub, K)
    # radii from the FULL point set (exact cover of all region cells)
    R = np.zeros(len(C), np.float64)
    for s in range(0, len(pts), 500000):  # chunked (pts can be millions)
        blk = pts[s:s + 500000]
        d2 = ((blk[:, None, :] - C[None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(1)
        dmin = np.sqrt(d2[np.arange(len(blk)), lab])
        np.maximum.at(R, lab, dmin)
    R = R + diag + MARGIN  # cell diagonal + empirical margin

    tau_run = TAU_RUN

    # validation: dense random samples
    rng = np.random.default_rng(2)
    M = 20_000_000
    q = rng.uniform(lo, hi, (M, 3)).astype(np.float32)
    dq = min_de((q[:, 0], q[:, 1], q[:, 2]))
    inside = np.zeros(M, bool)
    depth = np.full(M, -np.inf)
    for c, r in zip(C, R):
        dd = r - np.sqrt(((q - c[None, :]) ** 2).sum(1))
        depth = np.maximum(depth, dd)
    inside = depth > 0
    need = dq < F(tau_run)
    bad = need & ~inside
    print(f"# validation: {need.sum()} region samples, "
          f"{bad.sum()} outside cover "
          f"(min depth over region {depth[need].min():.4f})",
          file=sys.stderr)
    assert bad.sum() == 0, "cover validation FAILED"

    # perf figure: fraction of random rays through the 1.3-sphere
    # silhouette that miss every lobe (these skip the march entirely)
    o = np.array([0.0, 0.0, -4.0])
    # random points in the 1.3-disc at z=0
    t = rng.uniform(0, 2 * np.pi, 200000)
    rr = 1.3 * np.sqrt(rng.uniform(0, 1, 200000))
    tgt = np.stack([rr * np.cos(t), rr * np.sin(t), np.zeros_like(t)], 1)
    dirs = tgt - o[None, :]
    dirs /= np.sqrt((dirs ** 2).sum(1))[:, None]
    hit_any = np.zeros(len(dirs), bool)
    for c, r in zip(C, R):
        w = c[None, :] - o[None, :]
        pb = (w * dirs).sum(1)
        disc = pb * pb - ((w * w).sum(1) - r * r)
        hit_any |= disc > 0
    print(f"# rays through 1.3-silhouette missing all lobes: "
          f"{100.0 * (~hit_any).mean():.1f}%", file=sys.stderr)
    print(f"# sphere count {len(C)}, mean R {R.mean():.3f}, "
          f"max R {R.max():.3f}", file=sys.stderr)

    print("# Generated by tools/gen_lobe_bounds.py "
          f"(N={N}, K={K}, TAU_BUILD={TAU_BUILD}, iters={ITERATIONS}, "
          f"bailout={BAILOUT}, margin={MARGIN}+diag)")
    print(f"TAU_RUN = {tau_run:.4f}")
    print("LOBE_SPHERES_P8 = [")
    for c, r in zip(C, R):
        print(f"    ({c[0]:.5f}, {c[1]:.5f}, {c[2]:.5f}, {r:.5f}),")
    print("]")


if __name__ == "__main__":
    main()
