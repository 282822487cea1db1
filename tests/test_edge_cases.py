"""Degenerate-scene robustness cells: empty scenes, no lights, camera
inside an object's bounding sphere (legal — only inside a SOLID is
excluded), single-object frames. Both backends must agree and nothing
may NaN."""

import dataclasses

import numpy as np

from surfjax.api import (
    Camera, Material, PointLight, RenderSettings, Scene, Sphere,
)
from surfjax.core.camera import Intrinsics
from surfjax.pipeline.frame import render_frame


def _cam(w=48, h=32, pos=(0.0, 0.0, 0.0), target=(0.0, 0.0, 4.0)):
    return Camera.pinhole(w, h, 45.0, position=pos, target=target)


def test_empty_scene_renders_background():
    scene = Scene()
    scene.add_light(PointLight(position=(1.0, 2.0, 0.0)))
    st = RenderSettings(background=(0.1, 0.2, 0.3))
    for backend in ("jnp", "pallas"):
        fb = render_frame(scene, _cam(),
                          st.with_(backend=backend, tile_rows=8))
        rgb = np.asarray(fb.rgb)
        assert np.isfinite(rgb).all()
        assert (np.asarray(fb.hit) == 0).all()
        np.testing.assert_allclose(rgb[0, 0], [0.1, 0.2, 0.3], atol=1e-6)


def test_no_lights_ambient_only():
    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 4.0), radius=1.0),
              Material.lambert((0.5, 0.6, 0.7)), engine="sdf")
    st = RenderSettings(shadows=True)
    fbs = {}
    for backend in ("jnp", "pallas"):
        fb = render_frame(scene, _cam(),
                          st.with_(backend=backend, tile_rows=8))
        assert np.isfinite(np.asarray(fb.rgb)).all()
        assert np.asarray(fb.hit).mean() > 0.1
        fbs[backend] = fb
    np.testing.assert_allclose(np.asarray(fbs["jnp"].rgb),
                               np.asarray(fbs["pallas"].rgb), atol=2e-5)


def test_camera_inside_bound_sphere():
    """Camera INSIDE the object's (inflated) bounding sphere but outside
    the solid: _bound_entry's t_in < t_start case — the march must start
    at t_start, not behind the camera, and still hit the surface."""
    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 1.2), radius=1.0),
              Material.lambert((0.8, 0.3, 0.2)), engine="sdf")
    scene.add_light(PointLight(position=(2.0, 3.0, -2.0)))
    st = RenderSettings(shadows=False)
    cam = _cam(pos=(0.0, 0.0, -0.1), target=(0.0, 0.0, 1.2))
    fbs = {}
    for backend in ("jnp", "pallas"):
        fb = render_frame(scene, cam,
                          st.with_(backend=backend, tile_rows=8))
        hit = np.asarray(fb.hit)
        assert hit.mean() > 0.5  # sphere fills most of the view
        depth = np.asarray(fb.depth)[hit > 0]
        assert (depth > 0.05).all() and (depth < 0.5).all()
        fbs[backend] = fb
    np.testing.assert_array_equal(np.asarray(fbs["jnp"].hit),
                                  np.asarray(fbs["pallas"].hit))
    # separate march implementations land at different samples inside
    # the hit-eps band — depths agree to the band width
    np.testing.assert_allclose(np.asarray(fbs["jnp"].depth),
                               np.asarray(fbs["pallas"].depth),
                               atol=st.hit_eps + 1e-5)


def test_single_frame_sequence():
    """F=1 through the fused sequence kernel (degenerate frame axis)."""
    from surfjax.pipeline.frame import render_sequence
    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 4.0), radius=1.0),
              Material.lambert((0.5, 0.6, 0.7)), engine="sdf")
    scene.add_light(PointLight(position=(1.0, 2.0, 0.0)))
    cam = _cam()
    R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(cam.position, np.float32).reshape(1, 3)
    st = RenderSettings(backend="pallas", tile_rows=8)
    fb_seq = render_sequence(scene, cam, (R, pos), st)
    fb_one = render_frame(scene, cam, st)
    np.testing.assert_array_equal(np.asarray(fb_seq.hit[0]),
                                  np.asarray(fb_one.hit))
    np.testing.assert_allclose(np.asarray(fb_seq.rgb[0]),
                               np.asarray(fb_one.rgb), atol=1e-5)


def test_pallas_settings_validation():
    """Settings the Triton route cannot compile (or that would silently
    mis-tile) must raise a Python error at the pallas entry instead."""
    import pytest

    from surfjax import Camera, Material, PointLight, RenderSettings, \
        Scene, Sphere
    from surfjax.pipeline.frame import render_frame

    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 3.0), radius=1.0),
              Material.lambert())
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(64, 64, fov_y_deg=45.0)
    base = RenderSettings(backend="pallas", tile_rows=8)
    for bad in (base.with_(tile_rows=12),
                base.with_(tile_rows=0),
                base.with_(max_steps=0)):
        with pytest.raises(ValueError):
            render_frame(scene, cam, bad)
