"""surfjax quickstart: build a scene, render, G-buffer, animate, fit.

Runs everywhere JAX runs; on a GPU add backend="pallas" to
RenderSettings for the fused Triton kernels. From the repo root:

    python examples/quickstart.py          # writes /tmp/surfjax_quickstart/

API parity note (SURVEY.md §2 component 20): this is the scene/camera/
material surface the reference exposes — Scene.add(node, material),
CSG combinators, Camera.pinhole, render/render_sequence, fit_pose.
"""

import os

import numpy as np

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surfjax import (
    Box, Camera, Material, Plane, PointLight, RenderSettings, Scene,
    Sphere, render, render_sequence, smooth_union, subtract,
)

OUT = "/tmp/surfjax_quickstart"


def main():
    os.makedirs(OUT, exist_ok=True)

    # --- 1. a scene: CSG + smooth blends + floor -------------------------
    scene = Scene()
    scene.add(subtract(Box(center=(0.6, -0.2, 3.0),
                           half_extents=(0.45, 0.45, 0.45)),
                       Sphere(center=(0.6, 0.1, 2.7), radius=0.4)),
              Material.blinn_phong(albedo=(0.2, 0.45, 0.8), shininess=64))
    scene.add(smooth_union(Sphere(center=(-0.7, -0.3, 3.2), radius=0.5),
                           Sphere(center=(-0.2, 0.2, 3.0), radius=0.35),
                           0.25),
              Material.lambert(albedo=(0.4, 0.7, 0.45)), engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-0.9),
              Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))

    camera = Camera.pinhole(512, 384, fov_y_deg=45.0,
                            position=(0.0, 0.4, 0.0), target=(0.0, 0.0, 3.0))
    settings = RenderSettings(shadows=True, ao=True)

    # --- 2. render a frame; the G-buffer is plain arrays -----------------
    fb = render(scene, camera, settings)
    from surfjax.io.image import save_png
    save_png(os.path.join(OUT, "frame.png"), np.asarray(fb.rgb))
    print("frame.png:", fb.rgb.shape, "| hits:", int(np.asarray(fb.hit).sum()),
          "| depth range:",
          float(np.asarray(fb.depth)[np.asarray(fb.hit) > 0].min()),
          float(np.asarray(fb.depth)[np.asarray(fb.hit) > 0].max()))

    # --- 3. an on-device animated path (one jitted batch) ----------------
    # poses = (R_flats (F, 9), positions (F, 3)); here a small dolly
    F = 8
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    pos = np.asarray(camera.position, np.float32)
    poses = (np.stack([R] * F),
             pos[None, :] + np.float32(0.02) * np.arange(
                 F, dtype=np.float32)[:, None] * np.float32(1.0))
    fbs = render_sequence(scene, camera, poses, settings)
    print("sequence:", fbs.rgb.shape)

    # --- 4. inverse rendering: recover a perturbed pose ------------------
    # Gradients flow through the raymarcher via the implicit-function-
    # theorem custom_vjp. Fits want smooth targets: a blob scene with
    # plain shading (hard shadow/AO edges make poor pose gradients).
    from surfjax.diff.fit import fit_pose
    fit_scene = Scene()
    fit_scene.add(smooth_union(Sphere(center=(-0.35, -0.1, 3.0),
                                      radius=0.6),
                               Sphere(center=(0.45, 0.1, 3.0),
                                      radius=0.45), 0.3),
                  Material.lambert(albedo=(0.4, 0.6, 0.8)), engine="sdf")
    fit_scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    fit_settings = RenderSettings(shadows=False, max_steps=64, t_max=20.0)
    cam_s = Camera.pinhole(96, 72, fov_y_deg=45.0)
    target = np.asarray(render(fit_scene, cam_s, fit_settings).rgb)
    init = (np.asarray([0.04, -0.03, 0.02], np.float32),   # axis-angle
            np.asarray([0.05, -0.05, 0.0], np.float32))    # translation
    _R_fit, _t_fit, losses = fit_pose(fit_scene, cam_s, target, steps=80,
                                      lr=3e-2, settings=fit_settings,
                                      init=init)
    print(f"fit_pose: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    assert losses[-1] < losses[0] * 0.2


if __name__ == "__main__":
    main()
