"""Hybrid fit-forward tests (surfjax/diff/hybrid.py, r5).

The hybrid runs every march in the Pallas kernels (interpret mode on
this CPU backend) and reconstructs gradients via the frame-level IFT
custom_vjp + differentiable jnp shading at the hit points. Pinned here:

  1. forward VALUE bitwise equal to render_rays_pallas (the splices add
     exact float zeros; same kernel stages, same shade tail);
  2. the IFT backward agrees with central finite differences of the
     hybrid's own loss (validates the custom_vjp independently of the
     jnp path);
  3. hybrid pose loss/grad agrees with the jnp pipeline's to the
     marched-class tolerance (trajectories differ in the eps band —
     the documented c5 carve-out class);
  4. fit_pose converges with the hybrid forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tests.scenes import config5_anim_scene
from surfjax.core.camera import flat_camera_rays


def _freeze(scene, cam):
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    R = jnp.asarray(np.asarray(cam.rotation, np.float32).reshape(9))
    t = jnp.asarray(np.asarray(cam.position, np.float32))
    o, d, _ = flat_camera_rays(cam.intrinsics, R, t)
    return static, params, o, d


def test_hybrid_value_bitwise_vs_pallas():
    from surfjax.diff.hybrid import render_rays_hybrid
    from surfjax.kernels.render_tile import render_rays_pallas

    scene, cam, settings = config5_anim_scene(48)
    settings = settings.with_(backend="pallas", tile_rows=8)
    static, params, o, d = _freeze(scene, cam)

    fb_h = jax.jit(lambda p, o, d: render_rays_hybrid(
        static, settings, p, o, d))(params, o, d)
    fb_p = jax.jit(lambda p, o, d: render_rays_pallas(
        static, settings, p, o, d))(params, o, d)
    np.testing.assert_array_equal(np.asarray(fb_h.hit), np.asarray(fb_p.hit))
    np.testing.assert_array_equal(np.asarray(fb_h.depth),
                                  np.asarray(fb_p.depth))
    np.testing.assert_array_equal(np.asarray(fb_h.rgb), np.asarray(fb_p.rgb))
    np.testing.assert_array_equal(np.asarray(fb_h.obj_id),
                                  np.asarray(fb_p.obj_id))


def test_hybrid_ift_matches_finite_differences():
    """Central-FD check of the frame-level IFT custom_vjp on a SMOOTH
    observable: mean hit depth over interior pixels of a single SDF
    sphere, differentiated w.r.t. the sphere's leaf parameters.

    Interior pixels have no hit/shadow flips in the FD band, so t(theta)
    is smooth there and FD is trustworthy — unlike an image-mse FD,
    which samples the O(1) silhouette/shadow-flip jumps the IFT
    (correctly, and same as the jnp pipeline) does not model.
    Validates the custom_vjp independently of the jnp path."""
    from surfjax.api import Camera, Material, PointLight, Scene, Sphere
    from surfjax.core.types import RenderSettings
    from surfjax.diff.hybrid import render_rays_hybrid

    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 3.0), radius=0.8),
              Material.lambert((0.6, 0.4, 0.3)), engine="sdf")
    scene.add_light(PointLight(position=(2.0, 3.0, -1.0)))
    cam = Camera.pinhole(24, 24, 45.0, position=(0.0, 0.0, 0.0),
                         target=(0.0, 0.0, 3.0))
    settings = RenderSettings(backend="pallas", tile_rows=8, shadows=False)
    static, params, o, d = _freeze(scene, cam)

    # central 8x8 pixel block: always interior at this framing
    w = np.zeros((24, 24), np.float32)
    w[8:16, 8:16] = 1.0
    w = jnp.asarray(w.reshape(-1) / w.sum())

    def depth_loss(lp):
        p = dict(params, leaf_params=lp)
        fb = render_rays_hybrid(static, settings, p, o, d)
        return jnp.sum(fb.depth * w)

    loss_j = jax.jit(depth_loss)
    lp0 = params["leaf_params"]
    g = jax.jit(jax.grad(depth_loss))(lp0)

    rng = np.random.default_rng(3)
    # perturb only the sphere row (center xyz + radius); light rows are
    # not traced geometry
    v = np.zeros(lp0.shape, np.float32)
    v[0, :4] = rng.standard_normal(4).astype(np.float32)
    v /= np.linalg.norm(v)
    v = jnp.asarray(v)
    h = 1e-3
    fd = (float(loss_j(lp0 + h * v)) - float(loss_j(lp0 - h * v))) / (2 * h)
    an = float(jnp.sum(g * v))
    assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-6), (fd, an)


def test_hybrid_pose_grads_match_jnp_pipeline():
    """Hybrid vs jnp-pipeline pose loss+grad on the same backend.

    Trajectories differ in the hit-eps band (kernel march over-relaxes,
    bound-enters, early-exits; the jnp pipeline's sphere_trace does
    not), so agreement is the marched-class tolerance, not bitwise —
    the same class chip_smoke.py gates on the card."""
    from surfjax.diff.fit import pose_loss_and_grad

    scene, cam, settings = config5_anim_scene(48)
    l_h, g_h = pose_loss_and_grad(
        scene, cam, settings.with_(backend="pallas", tile_rows=8))
    l_j, g_j = pose_loss_and_grad(scene, cam,
                                  settings.with_(backend="jnp"))
    assert abs(l_h - l_j) / max(abs(l_j), 1e-12) < 2e-3
    gh = np.concatenate([g_h["w"], g_h["dt"]]).astype(np.float64)
    gj = np.concatenate([g_j["w"], g_j["dt"]]).astype(np.float64)
    rel = np.linalg.norm(gh - gj) / max(np.linalg.norm(gj), 1e-12)
    cos = float(gh @ gj / max(np.linalg.norm(gh) * np.linalg.norm(gj),
                              1e-30))
    assert rel < 0.1, rel
    assert cos > 0.995, cos


def test_fit_pose_converges_with_hybrid_forward():
    from surfjax.diff.fit import fit_pose
    from surfjax.pipeline.frame import render_frame

    scene, cam, settings = config5_anim_scene(32)
    st = settings.with_(backend="pallas", tile_rows=8)
    target = render_frame(scene, cam, st).rgb
    # start from a perturbed pose; recover
    init = (np.float32([0.03, -0.02, 0.01]), np.float32([0.02, 0.01, -0.02]))
    _, _, losses = fit_pose(scene, cam, np.asarray(target), steps=12,
                            lr=3e-2, settings=st, init=init)
    assert losses[-1] < 0.3 * losses[0], losses


def test_hybrid_rejects_crowd():
    import pytest
    from surfjax.diff.hybrid import render_rays_hybrid
    from surfjax.api import Camera, Material, Scene, Sphere, PointLight

    scene = Scene()
    for i in range(30):
        scene.add(Sphere(center=(i * 0.2 - 3.0, 0.0, 4.0), radius=0.08),
                  Material.lambert((0.5, 0.5, 0.5)), engine="sdf")
    scene.add_light(PointLight(position=(0.0, 4.0, 0.0)))
    cam = Camera.pinhole(16, 16, 45.0)
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    R = jnp.asarray(np.eye(3, dtype=np.float32).reshape(9))
    t = jnp.zeros(3, jnp.float32)
    o, d, _ = flat_camera_rays(cam.intrinsics, R, t)
    from surfjax.core.types import RenderSettings
    st = RenderSettings(backend="pallas", vector_objects=True, tile_rows=8)
    with pytest.raises(NotImplementedError):
        render_rays_hybrid(static, st, params, o, d)
