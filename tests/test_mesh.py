"""Mesh engine tests: grid-DDA vs brute force, Moller-Trumbore edge cases,
config-4 golden parity (SURVEY.md §4.2, BASELINE.json:10)."""

import jax
import jax.numpy as jnp
import numpy as np

from surfjax import Material, Scene, TriangleMesh, render
from surfjax.core.camera import camera_ray_dirs_dyn
from surfjax.engines.mesh import build_grid, intersect_mesh
from surfjax.golden import renderer as golden
from surfjax.meshgen import octasphere

from tests.scenes import config4_mesh


def _grid_vs_brute(mesh, o, d, t_min=1e-3, t_max=1e4):
    scene = Scene().add(mesh, Material.lambert())
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    t_g, tri_g = intersect_mesh(static.mesh_static[0], 0, params, o, d,
                                t_min, t_max)
    t_b, tri_b = golden._intersect_mesh_brute(
        mesh, tuple(np.asarray(c) for c in o),
        tuple(np.asarray(c) for c in d), np.float32(t_min),
        np.float32(t_max))
    return np.asarray(t_g), np.asarray(tri_g), t_b, tri_b


def test_grid_matches_brute_force(rng):
    v, f = octasphere(2)
    v = v * 0.8
    v[:, 2] += 3.0
    mesh = TriangleMesh(vertices=v, faces=f)
    n = 512
    ang = rng.uniform(-0.35, 0.35, (2, n)).astype(np.float32)
    dx = np.sin(ang[0])
    dy = np.sin(ang[1])
    dz = np.sqrt(1.0 - dx * dx - dy * dy).astype(np.float32)
    o = tuple(jnp.zeros(n, jnp.float32) for _ in range(3))
    d = (jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz))
    t_g, tri_g, t_b, tri_b = _grid_vs_brute(mesh, o, d)
    hit_g = t_g < 1e29
    hit_b = t_b < 1e29
    np.testing.assert_array_equal(hit_g, hit_b)
    np.testing.assert_allclose(t_g[hit_g], t_b[hit_b], rtol=1e-5)
    # triangle ids can differ only at shared edges; t agreement is the check


def test_grid_ray_from_inside(rng):
    v, f = octasphere(1)
    v = v * 1.0
    mesh = TriangleMesh(vertices=v, faces=f)
    # origin inside the sphere mesh
    n = 64
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    d = (jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang)),
         jnp.zeros(n, jnp.float32))
    o = tuple(jnp.zeros(n, jnp.float32) for _ in range(3))
    t_g, _, t_b, _ = _grid_vs_brute(mesh, o, d)
    np.testing.assert_allclose(t_g, t_b, rtol=1e-5)
    assert (t_g < 2.0).all()  # all rays hit from inside


def test_config4_parity():
    scene, cam, settings = config4_mesh(width=192, height=108)
    fb = render(scene, cam, settings)
    gold = golden.render(scene, cam, settings)
    hit_agree = (np.asarray(fb.hit) == gold["hit"]).mean()
    assert hit_agree > 0.999, f"hit masks agree {hit_agree}"
    d = np.abs(np.asarray(fb.rgb).astype(np.float64)
               - gold["rgb"].astype(np.float64))
    assert d.max() < 1e-3, f"config4 rgb deviates {d.max()}"
    dn = np.abs(np.asarray(fb.normal) - gold["normal"])
    assert dn.max() < 1e-3
    # G-buffer sanity: depth and normal populated on hits
    assert (np.asarray(fb.depth)[np.asarray(fb.hit) > 0] > 0).all()


def test_config4_pallas_packet_matches_golden():
    scene, cam, settings = config4_mesh(width=192, height=108)
    fb = render(scene, cam, settings.with_(backend="pallas", tile_rows=8))
    gold = golden.render(scene, cam, settings)
    assert (np.asarray(fb.hit) == gold["hit"]).mean() > 0.999
    d = np.abs(np.asarray(fb.rgb).astype(np.float64)
               - gold["rgb"].astype(np.float64))
    assert d.max() < 1e-3, f"packet-kernel rgb deviates {d.max()}"


def test_native_grid_builder_matches_python():
    """The C++ CSR binning must equal the Python fallback exactly."""
    from surfjax.native import grid_bin
    v, f = octasphere(3)
    v = v * 0.8
    v[:, 2] += 3.0
    mesh = TriangleMesh(vertices=v, faces=f)
    tables = build_grid(mesh)  # uses native when available
    ms = tables.static

    # recompute with the pure-Python fallback
    import numpy as _np
    bb_min = _np.asarray(ms.bbox_min, _np.float32)
    cell = _np.asarray(ms.cell_size, _np.float32)
    nx, ny, nz = ms.nx, ms.ny, ms.nz
    cells = [[] for _ in range(nx * ny * nz)]
    v0 = v[f[:, 0]]
    v1 = v[f[:, 1]]
    v2 = v[f[:, 2]]
    tmin = _np.minimum(_np.minimum(v0, v1), v2)
    tmax = _np.maximum(_np.maximum(v0, v1), v2)
    lo = _np.clip(((tmin - bb_min) / cell).astype(_np.int64), 0,
                  [nx - 1, ny - 1, nz - 1])
    hi = _np.clip(((tmax - bb_min) / cell).astype(_np.int64), 0,
                  [nx - 1, ny - 1, nz - 1])
    for fi in range(f.shape[0]):
        for ix in range(lo[fi, 0], hi[fi, 0] + 1):
            for iy in range(lo[fi, 1], hi[fi, 1] + 1):
                for iz in range(lo[fi, 2], hi[fi, 2] + 1):
                    cells[(ix * ny + iy) * nz + iz].append(fi)
    counts = _np.asarray([len(c) for c in cells], _np.int32)
    start = _np.zeros(len(cells) + 1, _np.int32)
    _np.cumsum(counts, out=start[1:])
    tris = _np.concatenate([_np.asarray(c, _np.int32)
                            for c in cells if c])

    got = grid_bin(v, f, bb_min, cell, nx, ny, nz)
    assert got is not None, "native builder failed to load"
    _np.testing.assert_array_equal(got[0], start)
    _np.testing.assert_array_equal(got[1][:tris.shape[0]], tris)


def test_two_meshes_pallas_and_golden():
    """Two meshes with different face counts: golden (fixed this round),
    jnp, and the pallas packet kernel must all agree."""
    v1, f1 = octasphere(2)
    v1 = v1 * 0.6
    v1 = v1 + np.asarray([-0.8, 0.0, 3.0], np.float32)
    v2 = np.asarray([[0.5, -0.5, 2.5], [1.5, -0.5, 2.5], [1.0, 0.8, 3.0]],
                    np.float32)
    f2 = np.asarray([[0, 1, 2]], np.int32)
    scene = Scene()
    scene.add(TriangleMesh(vertices=v1, faces=f1),
              Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(TriangleMesh(vertices=v2, faces=f2),
              Material.lambert(albedo=(0.3, 0.4, 0.8)))
    from surfjax import PointLight, Camera, RenderSettings
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(96, 96, 45.0)
    st = RenderSettings(shadows=True)
    gold = golden.render(scene, cam, st)
    for bk in ("jnp", "pallas"):
        fb = render(scene, cam, st.with_(backend=bk, tile_rows=8))
        assert (np.asarray(fb.hit) == gold["hit"]).mean() > 0.999, bk
        d = np.abs(np.asarray(fb.rgb) - gold["rgb"])
        assert d.max() < 1e-3, (bk, d.max())

def test_packet_overflow_full_table_matches_golden(monkeypatch):
    """Tiles with more than PACKET_K candidates scan the full packed
    triangle table instead (lax.cond outside the kernel picks the
    variant that carries it). Exercised by lowering the budget so most
    tiles overflow; results must still equal the golden's nearest hits."""
    from surfjax.kernels import mesh_tile

    scene, cam, settings = config4_mesh(width=96, height=96)
    gold = golden.render(scene, cam, settings)
    monkeypatch.setattr(mesh_tile, "PACKET_K", 8)
    fb = render(scene, cam, settings.with_(backend="pallas", tile_rows=8))
    assert (np.asarray(fb.hit) == gold["hit"]).mean() > 0.999
    d = np.abs(np.asarray(fb.rgb).astype(np.float64)
               - gold["rgb"].astype(np.float64))
    assert d.max() < 1e-3, f"overflow-path rgb deviates {d.max()}"


def test_mesh_with_ao_and_soft_shadows_pallas_matches_golden():
    """The VERDICT round-1 gap: pallas forced ao=1 at mesh hits while
    golden/jnp probe the non-mesh scene SDF there. Mesh + SDF sphere +
    analytic floor with ao=True and soft_shadows=True must now agree
    across golden, jnp, and pallas."""
    from surfjax import Camera, Plane, PointLight, RenderSettings, Sphere

    v, f = octasphere(2)
    v = v * 0.5
    v = v + np.asarray([0.6, -0.2, 2.8], np.float32)
    scene = Scene()
    scene.add(TriangleMesh(vertices=v, faces=f),
              Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(Sphere(center=(-0.6, -0.1, 3.0), radius=0.5),
              Material.lambert(albedo=(0.3, 0.7, 0.4)), engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-0.7),
              Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(96, 96, 45.0, position=(0.0, 0.3, 0.0),
                         target=(0.0, 0.0, 3.0))
    st = RenderSettings(shadows=True, soft_shadows=True, ao=True,
                        ao_samples=5, max_steps=128)
    gold = golden.render(scene, cam, st)
    assert 0.3 < gold["hit"].mean() <= 1.0
    fb_j = render(scene, cam, st)
    assert (np.asarray(fb_j.hit) == gold["hit"]).mean() > 0.999
    dj = np.abs(np.asarray(fb_j.rgb).astype(np.float64)
                - gold["rgb"].astype(np.float64))
    assert dj.max() < 1e-3, f"jnp rgb deviates {dj.max()}"
    # pallas: per-object penumbra (closed-form plane/sphere) vs golden's
    # scene-min march — mesh-hit AO must match exactly (the fixed bug);
    # penumbra sampling differences are tolerance-bounded
    fb_p = render(scene, cam, st.with_(backend="pallas", tile_rows=8))
    assert (np.asarray(fb_p.hit) == gold["hit"]).mean() > 0.995
    dp = np.abs(np.asarray(fb_p.rgb).astype(np.float64)
                - gold["rgb"].astype(np.float64))
    assert np.quantile(dp, 0.99) < 5e-2, np.quantile(dp, 0.99)
    assert dp.mean() < 5e-3, dp.mean()
    # the AO channel itself at mesh-hit pixels: compare ao-on vs ao-off
    # pallas renders; they must differ where the SDF sphere shades the
    # mesh (ao=1 would make them identical there)
    fb_p0 = render(scene, cam,
                   st.with_(backend="pallas", tile_rows=8, ao=False))
    mesh_px = np.asarray(fb_p.obj_id) == 0
    d_ao = np.abs(np.asarray(fb_p.rgb) - np.asarray(fb_p0.rgb))[mesh_px]
    assert d_ao.max() > 1e-3, "AO has no effect on mesh hits (ao=1 bug)"


def test_native_obj_loader_matches_python():
    """Native C++ OBJ loader == the Python fallback parser, including
    quads (fan triangulation), i/j/k face syntax and negative indices."""
    import textwrap

    import numpy as np

    from surfjax import config as cfg

    obj = textwrap.dedent("""\
        # comment
        v 0.0 0.0 0.0
        v 1.0 0.0 0.0
        v 1.0 1.0 0.5
        v 0.0 1.0 0.0
        v 0.5 0.5 2.0
        f 1 2 3 4
        f 1/1 2/2 5/3
        f -3//1 -2//2 -1//3
        """)
    import tempfile, os
    with tempfile.NamedTemporaryFile("w", suffix=".obj",
                                     delete=False) as fh:
        fh.write(obj)
        path = fh.name
    try:
        native = cfg.load_obj(path)

        # exercise the REAL Python fallback path by disabling the
        # native loader (restores after)
        import surfjax.native as sn
        orig = sn.load_obj
        sn.load_obj = lambda p: None
        try:
            py = cfg.load_obj(path)
        finally:
            sn.load_obj = orig

        np.testing.assert_array_equal(native[0], py[0])
        np.testing.assert_array_equal(native[1], py[1])
        assert native[1].shape == (4, 3)  # quad -> 2 tris + 2 single tris
    finally:
        os.unlink(path)


def test_mesh_candidates_conservative():
    """Per-tile candidate culling must be CONSERVATIVE: every triangle a
    lane's Moller-Trumbore test hits within its [t_min, t_max] segment
    must appear in that lane's tile candidate set (or the tile must
    overflow K so the kernel routes to the full-table scan). Checked at
    two tile shapes — a reduced-precision k-DOP einsum (bf16 or TF32
    products) shrinks projection ranges past the eps guard and once
    dropped a true near hit on 118 c4 pixels, so the projection pins
    HIGHEST precision and this property is CI-gated."""
    import jax.numpy as jnp
    from surfjax.kernels.mesh_tile import mesh_candidates

    v, f = octasphere(3)
    v = v * 0.9
    v[:, 2] += 3.2
    mesh = TriangleMesh(vertices=v, faces=f)
    tables = build_grid(mesh)
    tri_packed = np.asarray(tables.arrays["tri_packed"], np.float32)
    Fn = tri_packed.shape[0]

    rows, lanes = 64, 128
    n = rows * lanes
    rng = np.random.default_rng(7)
    ang = rng.uniform(-0.4, 0.4, (2, n)).astype(np.float32)
    dx, dy = np.sin(ang[0]), np.sin(ang[1])
    dz = np.sqrt(1.0 - dx * dx - dy * dy).astype(np.float32)
    o_np = [np.zeros(n, np.float32) for _ in range(3)]
    d_np = [dx, dy, dz]
    t_min, t_max = np.float32(1e-3), np.float32(1e4)

    # brute-force per-lane hits (same accept test as the kernel body)
    v0 = tri_packed[:, 0:3]
    e1 = tri_packed[:, 3:6]
    e2 = tri_packed[:, 6:9]
    d_all = np.stack(d_np, -1)[:, None, :]        # (n,1,3)
    o_all = np.stack(o_np, -1)[:, None, :]
    pv = np.cross(d_all, e2[None])
    det = (e1[None] * pv).sum(-1)
    ok = np.abs(det) > 1e-7
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = o_all - v0[None]
    u = (tv * pv).sum(-1) * inv
    qv = np.cross(tv, e1[None])
    vv = (d_all * qv).sum(-1) * inv
    t = (e2[None] * qv).sum(-1) * inv
    hits = (ok & (u >= 0) & (vv >= 0) & (u + vv <= 1.0)
            & (t > t_min) & (t < t_max))          # (n, Fn)

    for R in (16, 64):
        o2 = tuple(jnp.asarray(c.reshape(rows, lanes)) for c in o_np)
        d2 = tuple(jnp.asarray(c.reshape(rows, lanes)) for c in d_np)
        cand, counts = mesh_candidates(
            tables.static, jnp.asarray(tri_packed), o2, d2,
            float(t_min), float(t_max), R)
        cand = np.asarray(cand)
        counts = np.asarray(counts)
        K = cand.shape[1]
        tiles = rows // R
        tile_hits = hits.reshape(tiles, R * lanes, Fn).any(axis=1)
        for ti in range(tiles):
            if counts[ti] > K:
                continue  # kernel takes the exact full-table scan
            got = cand[ti, :counts[ti]]
            for fi in np.nonzero(tile_hits[ti])[0]:
                row = tri_packed[fi]
                present = np.any(np.all(got == row[None], axis=1))
                assert present, (
                    f"tile {ti} (R={R}): hit triangle {fi} culled from "
                    f"the candidate set ({counts[ti]}/{K})")
