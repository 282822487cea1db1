"""Engine unit tests: CSG event algebra, slab tests, SDF properties,
sphere-trace vs analytic agreement (SURVEY.md §4.2)."""

import jax
import jax.numpy as jnp
import numpy as np

from surfjax import (
    Box, Material, Plane, Scene, Sphere, intersect, subtract, union,
    smooth_union,
)
from surfjax.core.math import BIG
from surfjax.core.scene_compile import compile_scene
from surfjax.engines.analytic import intersect_analytic
from surfjax.engines.sdf import eval_sdf, _sphere_trace_impl, sphere_trace


def _compile_single(node, engine=None):
    s = Scene().add(node, Material.lambert(), engine=engine)
    static, params = s.freeze()
    return static.ir.objects[0], {k: jnp.asarray(v)
                                  for k, v in params.items()}


def _ray(o, d):
    d = np.asarray(d, np.float64)
    d = d / np.sqrt((d * d).sum())
    return (tuple(jnp.float32(x) * jnp.ones(1) for x in o),
            tuple(jnp.float32(x) * jnp.ones(1) for x in d))


def test_union_nearest():
    node = union(Sphere((0, 0, 5), 1.0), Sphere((0, 0, 9), 1.0))
    oir, p = _compile_single(node)
    o, d = _ray((0, 0, 0), (0, 0, 1))
    t, leaf = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    np.testing.assert_allclose(float(t[0]), 4.0, rtol=1e-6)
    assert int(leaf[0]) == 0


def test_intersect_lens():
    node = intersect(Sphere((0, 0, 5), 1.0), Sphere((0, 0, 6), 1.0))
    oir, p = _compile_single(node)
    o, d = _ray((0, 0, 0), (0, 0, 1))
    t, leaf = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    # lens near surface: entry of the FARTHER constraint = sphere2 at t=5
    np.testing.assert_allclose(float(t[0]), 5.0, rtol=1e-6)
    assert int(leaf[0]) == 1


def test_subtract_carve():
    node = subtract(Sphere((0, 0, 5), 1.0), Sphere((0, 0, 4), 0.5))
    oir, p = _compile_single(node)
    o, d = _ray((0, 0, 0), (0, 0, 1))
    t, leaf = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    # front of A at t=4 is inside the carved B(3.5..4.5) -> first surface is
    # B's exit at t=4.5 (a concave carved surface)
    np.testing.assert_allclose(float(t[0]), 4.5, rtol=1e-6)
    assert int(leaf[0]) == 1


def test_subtract_miss_through_hole():
    # carve a tunnel: ray passes entirely through the subtracted cylinder
    node = subtract(Box((0, 0, 5), (1, 1, 1)), Box((0, 0, 5), (0.3, 0.3, 2)))
    oir, p = _compile_single(node)
    o, d = _ray((0, 0, 0), (0, 0, 1))
    t, _ = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    assert float(t[0]) > 1e29  # straight through the hole


def test_box_slab_edges():
    oir, p = _compile_single(Box((0, 0, 5), (1, 1, 1)))
    # axis-parallel ray inside the slab (d.x == 0, inside x range)
    o, d = _ray((0.5, 0.0, 0.0), (0, 0, 1))
    t, _ = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    np.testing.assert_allclose(float(t[0]), 4.0, rtol=1e-6)
    # axis-parallel ray outside the slab -> miss
    o, d = _ray((2.0, 0.0, 0.0), (0, 0, 1))
    t, _ = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    assert float(t[0]) > 1e29


def test_plane_halfspace():
    oir, p = _compile_single(Plane((0, 1, 0), -1.0))
    o, d = _ray((0, 0, 0), (0, -1, 0))
    t, _ = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)
    # looking up: no hit
    o, d = _ray((0, 0, 0), (0, 1, 0))
    t, _ = intersect_analytic(oir, p["leaf_params"], o, d, 1e-3, 1e4)
    assert float(t[0]) > 1e29


def test_smooth_union_k_to_0_is_min(rng):
    a = Sphere((0.3, 0, 0), 1.0)
    b = Box((-0.4, 0.2, 0), (0.5, 0.5, 0.5))
    pts = tuple(jnp.asarray(rng.normal(size=200).astype(np.float32) * 2)
                for _ in range(3))
    oir_s, p_s = _compile_single(smooth_union(a, b, 1e-6), engine="sdf")
    oir_u, p_u = _compile_single(union(a, b), engine="sdf")
    vs = eval_sdf(oir_s, p_s["leaf_params"], p_s["node_params"], pts)
    vu = eval_sdf(oir_u, p_u["leaf_params"], p_u["node_params"], pts)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(vu), atol=2e-6)


def test_sdf_sphere_sign(rng):
    oir, p = _compile_single(Sphere((0, 0, 0), 1.0), engine="sdf")
    pts = tuple(jnp.asarray(rng.normal(size=500).astype(np.float32))
                for _ in range(3))
    v = np.asarray(eval_sdf(oir, p["leaf_params"], p["node_params"], pts))
    r = np.sqrt(sum(np.asarray(c) ** 2 for c in pts))
    np.testing.assert_allclose(v, r - 1.0, atol=1e-6)


def test_sphere_trace_matches_analytic():
    oir_s, p_s = _compile_single(Sphere((0, 0, 5), 1.0), engine="sdf")
    oir_a, p_a = _compile_single(Sphere((0, 0, 5), 1.0))
    n = 64
    ang = np.linspace(-0.15, 0.15, n).astype(np.float32)
    d = (jnp.asarray(np.sin(ang)), jnp.zeros(n, jnp.float32),
         jnp.asarray(np.cos(ang)))
    o = tuple(jnp.zeros(n, jnp.float32) for _ in range(3))
    t_m, hit = _sphere_trace_impl(oir_s, p_s["leaf_params"],
                                  p_s["node_params"], o, d,
                                  1e-3, 1e4, 256, 1e-4)
    t_a, _ = intersect_analytic(oir_a, p_a["leaf_params"], o, d, 1e-3, 1e4)
    hit_a = np.asarray(t_a) < 1e29
    np.testing.assert_array_equal(np.asarray(hit), hit_a)
    err = np.abs(np.asarray(t_m) - np.asarray(t_a))[hit_a]
    assert err.max() < 5e-3  # march converges to within ~hit_eps scale


def test_mandelbulb_de_bounded():
    from surfjax import Mandelbulb
    oir, p = _compile_single(Mandelbulb(center=(0, 0, 0)), engine="sdf")
    # far away, DE must be positive and not wildly overestimate distance
    pts = (jnp.asarray([3.0, 0.0, 2.5], jnp.float32),
           jnp.asarray([0.0, 3.0, 0.0], jnp.float32),
           jnp.asarray([0.0, 0.0, 2.0], jnp.float32))
    v = np.asarray(eval_sdf(oir, p["leaf_params"], p["node_params"], pts))
    assert (v > 0).all()
    r = np.sqrt(np.asarray([9 + 0 + 0, 0 + 9 + 0, 2.5**2 + 4]))
    assert (v <= r).all()  # DE is a lower bound on distance; bulb radius ~1.2


def test_mandelbulb_general_power_renders_and_matches_golden():
    """power != 8 uses the general trig DE on every path, the pallas
    kernels included (no bounding-sphere shortcuts: the bulb bound
    factors are validated for power 8 only)."""
    from surfjax import (
        Camera, Mandelbulb, Material, PointLight, RenderSettings, Scene,
        render,
    )
    from surfjax.golden import renderer as golden

    scene = Scene()
    scene.add(Mandelbulb(center=(0.0, 0.0, 3.0), scale=0.9, power=5,
                         iterations=6),
              Material.lambert(albedo=(0.8, 0.6, 0.3)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(64, 64, 45.0)
    st = RenderSettings(shadows=True, max_steps=128)
    fb = render(scene, cam, st)
    gold = golden.render(scene, cam, st)
    assert 0.05 < gold["hit"].mean() < 0.9  # the bulb is visible
    assert (np.asarray(fb.hit) == gold["hit"]).mean() > 0.99
    d = np.abs(np.asarray(fb.rgb).astype(np.float64)
               - gold["rgb"].astype(np.float64))
    # trig (sin/cos/acos/atan2) differs between XLA and libm; chaotic DE
    # silhouettes may flip — the bulk must still be tight
    assert np.quantile(d, 0.99) < 1e-2
    # the oracle trajectory (over_relax=1.0): relaxed steps land hits
    # elsewhere in the eps band, where FD normals of a fractal decorrelate
    fb_p = render(scene, cam, st.with_(backend="pallas", tile_rows=8,
                                       over_relax=1.0))
    assert (np.asarray(fb_p.hit) == gold["hit"]).mean() > 0.99
    d_p = np.abs(np.asarray(fb_p.rgb).astype(np.float64)
                 - gold["rgb"].astype(np.float64))
    assert np.quantile(d_p, 0.99) < 1e-2


def test_bulb_bound_constants():
    """Validate the two bulb bounding-radius factors against the LIVE DE
    (kernels/render_tile.py BULB_BOUND_COVER / BULB_BOUND_LOWER):
    COVER: the hit region {DE_it < 0.05} stays inside radius 1.3;
    LOWER: the sphere SDF |p| - 1.39 pointwise lower-bounds the DE
    (measured max(|p| - DE) = 1.3607 at r0 ~ 2.70 — the raw-DE
    underestimation shell). Swept over EVERY iteration count the
    runtime can produce for power 8 (LoD caps are arbitrary ints in
    [1, p1]; p1 up to 16 covered) — the lower-bound property is used by
    influence windows/AO gates at whatever count the march evaluates.
    Also pins tools/gen_lobe_bounds.py's NumPy copy of the DE to the
    engine implementation (drift guard for the cover/validation tools).
    """
    import numpy as np

    from surfjax.engines.sdf import sdf_mandelbulb
    from surfjax.kernels.render_tile import (
        BULB_BOUND_COVER, BULB_BOUND_LOWER,
    )
    from tools.gen_lobe_bounds import canonical_de

    prm = jnp.asarray([0.0, 0.0, 0.0, 1.0, 2.0], jnp.float32)
    rng = np.random.default_rng(5)
    for it in (1, 2, 3, 4, 5, 6, 7, 8, 16):
        n = 800_000
        q = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
        # extra samples concentrated in the known worst shell r0 ~ 2-4
        sh = rng.normal(size=(n // 2, 3)).astype(np.float32)
        sh /= np.sqrt((sh * sh).sum(1))[:, None]
        sh *= rng.uniform(2.0, 4.0, (n // 2, 1)).astype(np.float32)
        q = np.concatenate([q, sh], axis=0)
        r0 = np.sqrt((q * q).sum(1))
        de = np.asarray(sdf_mandelbulb(
            prm, (jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
                  jnp.asarray(q[:, 2])), 8, it))
        # LOWER: |p| - R_lower <= DE everywhere
        assert float((r0 - de).max()) <= BULB_BOUND_LOWER, it
        # COVER: hit-region points lie inside R_cover
        near = de < np.float32(0.05)
        assert near.sum() > 1000
        assert float(r0[near].max()) < BULB_BOUND_COVER, it
        # tool-copy drift guard (jnp-vs-numpy FP differs at ULP scale)
        de_tool = canonical_de((q[:, 0], q[:, 1], q[:, 2]), it)
        np.testing.assert_allclose(de_tool, de, atol=2e-5, rtol=1e-4)


def test_mandelbulb_cheb_iteration_matches_std():
    """The restructured power-8 substep (bulb_iter='cheb',
    sdf_mandelbulb_while_cheb) is the SAME map algebraically — DE values
    must agree to f32 reassociation noise at points the iteration
    handles smoothly, and the two variants' renders must agree except
    for eps-band scatter at chaotic silhouettes."""
    import jax.numpy as jnp
    from surfjax import (
        Camera, Mandelbulb, Material, Plane, PointLight, RenderSettings,
        Scene, render,
    )
    from surfjax.engines.sdf import (
        sdf_mandelbulb_while, sdf_mandelbulb_while_cheb,
    )

    rng = np.random.default_rng(3)
    pts = tuple(jnp.asarray(rng.uniform(-2.0, 2.0, 4096), jnp.float32)
                for _ in range(3))
    prm = jnp.asarray([0.0, 0.0, 0.0, 1.0, 2.0, 0.0, 0.0, 0.0],
                      jnp.float32)
    d_std = np.asarray(sdf_mandelbulb_while(prm, pts, 8, 8))
    d_cheb = np.asarray(sdf_mandelbulb_while_cheb(prm, pts, 8, 8))
    rel = np.abs(d_std - d_cheb) / (np.abs(d_std) + 1e-6)
    # the chaotic iteration amplifies 1-ulp reassociation shifts near
    # the set; the bulk of points must agree tightly
    assert np.quantile(rel, 0.9) < 1e-4, np.quantile(rel, 0.9)
    assert np.median(rel) < 1e-6

    scene = Scene()
    scene.add(Mandelbulb(center=(0.0, 0.0, 3.0), scale=0.9),
              Material.lambert(albedo=(0.7, 0.5, 0.3)), engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-1.2),
              Material.lambert(albedo=(0.5, 0.5, 0.5)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(96, 96, fov_y_deg=45.0)
    s = RenderSettings(shadows=True, backend="pallas", tile_rows=8,
                       max_steps=128)
    # explicit on BOTH sides — the default flipped to cheb (r4)
    fb_std = render(scene, cam, s.with_(bulb_iter="std"))
    fb_cheb = render(scene, cam, s.with_(bulb_iter="cheb"))
    hit_s = np.asarray(fb_std.hit)
    hit_c = np.asarray(fb_cheb.hit)
    assert (hit_s == hit_c).mean() > 0.995  # silhouette scatter only
    both = (hit_s > 0.5) & (hit_c > 0.5)
    d = np.abs(np.asarray(fb_std.rgb) - np.asarray(fb_cheb.rgb))
    d_hit = d.max(axis=-1)[both]
    assert np.quantile(d_hit, 0.9) < 2e-2, np.quantile(d_hit, 0.9)
