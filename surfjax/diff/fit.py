"""Inverse rendering: pose and SDF-parameter fitting (component 19).

BASELINE.json:11 — "differentiable render: gradients through the raymarcher
for inverse pose/SDF fitting". The forward model is the ordinary frame
pipeline; gradients flow through the march via the IFT custom_vjp
(engines/sdf.sphere_trace) and through shading/normals by plain AD.
Optimizer: optax Adam. The whole fit step is one jitted program; the only
host interaction is the outer step loop (SURVEY.md §3.3).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from surfjax.core.math import F32
from surfjax.core.types import RenderSettings
from surfjax.pipeline.frame import render_rays


def rodrigues(w):
    """Rotation matrix (9,) row-major from an axis-angle 3-vector (traced).

    R = I + sin(t) K + (1 - cos(t)) K^2, t = |w|, K = skew(w/t).
    Safe at t -> 0.
    """
    t2 = jnp.sum(w * w)
    t = jnp.sqrt(t2 + F32(1e-20))
    safe = t > F32(1e-8)
    kx, ky, kz = w[0] / t, w[1] / t, w[2] / t
    s = jnp.sin(t)
    c = jnp.cos(t)
    one_c = F32(1.0) - c
    R = jnp.stack([
        c + kx * kx * one_c, kx * ky * one_c - kz * s,
        kx * kz * one_c + ky * s,
        ky * kx * one_c + kz * s, c + ky * ky * one_c,
        ky * kz * one_c - kx * s,
        kz * kx * one_c - ky * s, kz * ky * one_c + kx * s,
        c + kz * kz * one_c,
    ])
    eye = jnp.asarray([1, 0, 0, 0, 1, 0, 0, 0, 1], jnp.float32)
    return jnp.where(safe, R, eye)


def _matmul9(a, b):
    """(9,) row-major 3x3 product a @ b.

    HIGHEST precision: a float32 matmul on the GPU defaults to TF32
    (10-bit mantissa, ~1e-3 rel — the failure class of the mesh-cull
    find in kernels/mesh_tile.py), which would perturb every camera ray
    of a fitted pose; a 3x3 product is free at full precision."""
    a = a.reshape(3, 3)
    b = b.reshape(3, 3)
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST).reshape(9)


def _frame_rgb(static, intr, settings, params, R_flat, cam_pos):
    from surfjax.core.camera import flat_camera_rays
    o, d, _ = flat_camera_rays(intr, R_flat, cam_pos)
    if settings.backend == "pallas":
        # Pallas fit forward (r4 verdict Next #3): every march runs in
        # the kernels; gradients re-enter via the frame-level IFT
        # custom_vjp + differentiable shading at the hit points
        from surfjax.diff.hybrid import render_rays_hybrid
        fb = render_rays_hybrid(static, settings, params, o, d)
    else:
        fb = render_rays(static, settings, params, o, d)
    return fb.rgb.reshape(intr.height, intr.width, 3)


def fit_pose(scene, camera, target_rgb, steps: int = 100, lr: float = 2e-2,
             settings: RenderSettings = RenderSettings(),
             init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 50,
             verbose: bool = False):
    """Recover the camera pose that produced `target_rgb`.

    Optimizes an axis-angle delta-rotation w (applied to the camera's
    current rotation) and a position delta. Returns
    (R_flat (9,), position (3,), losses list).
    """
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics
    R0 = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    t0 = jnp.asarray(np.asarray(camera.position, np.float32))
    target = jnp.asarray(target_rgb, jnp.float32)

    def loss_fn(x):
        R = _matmul9(rodrigues(x["w"]), R0)
        rgb = _frame_rgb(static, intr, settings, params, R, t0 + x["dt"])
        diff = rgb - target
        return jnp.mean(diff * diff)

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    x = {"w": jnp.zeros(3, jnp.float32), "dt": jnp.zeros(3, jnp.float32)}
    if init is not None:
        x = {"w": jnp.asarray(init[0], jnp.float32),
             "dt": jnp.asarray(init[1], jnp.float32)}
    state = opt.init(x)

    @jax.jit
    def step(x, state):
        loss, g = jax.value_and_grad(loss_fn)(x)
        updates, state = opt.update(g, state)
        return optax.apply_updates(x, updates), state, loss

    start = 0
    if checkpoint_path is not None:
        import os
        from surfjax.utils.checkpoint import load_fit_state, save_fit_state
        if os.path.exists(checkpoint_path):
            start, x, state = load_fit_state(checkpoint_path, x, state)
    losses = []
    for i in range(start, steps):
        x, state, loss = step(x, state)
        losses.append(float(loss))
        if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
            save_fit_state(checkpoint_path, i + 1, x, state)
        if verbose and i % 10 == 0:
            print(f"fit_pose step {i}: loss {losses[-1]:.6g}")
    R = _matmul9(rodrigues(x["w"]), R0)
    return np.asarray(R), np.asarray(t0 + x["dt"]), losses


def pose_loss_and_grad(scene, camera, settings: RenderSettings,
                       w=(0.02, -0.01, 0.015), dt=(0.01, -0.02, 0.005),
                       target_value: float = 0.5, pixel_weight=None):
    """One pose-fit loss+gradient evaluation at a FIXED probe point.

    The same deterministic computation runs on the hybrid fit forward
    (settings.backend == 'pallas') and on the jnp pipeline, and the
    results must agree to tolerance (tests/test_hybrid.py). The target
    is a constant image (no cross-backend render dependence) and the
    probe (w, dt) is fixed and nonzero so the gradient is generic.
    Returns (loss, grad dict {'w','dt'}) as numpy.

    pixel_weight: optional (H, W) float weights for the mse (e.g. to
    exclude cross-backend hit-flip pixels). None = plain mean (the fit's
    own loss).
    """
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics
    R0 = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    t0 = jnp.asarray(np.asarray(camera.position, np.float32))
    target = jnp.full((intr.height, intr.width, 3), np.float32(target_value))
    if pixel_weight is not None:
        pw = jnp.asarray(pixel_weight, jnp.float32)
        denom = F32(3.0) * jnp.maximum(jnp.sum(pw), F32(1.0))

    def loss_fn(x):
        R = _matmul9(rodrigues(x["w"]), R0)
        rgb = _frame_rgb(static, intr, settings, params, R, t0 + x["dt"])
        diff = rgb - target
        if pixel_weight is None:
            return jnp.mean(diff * diff)
        return jnp.sum((diff * diff) * pw[..., None]) / denom

    x = {"w": jnp.asarray(w, jnp.float32), "dt": jnp.asarray(dt, jnp.float32)}
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(x)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def pose_probe_hit(scene, camera, settings: RenderSettings,
                   w=(0.02, -0.01, 0.015), dt=(0.01, -0.02, 0.005)):
    """(H, W) bool hit mask at the pose-fit probe pose — rendered on both
    backends to count the hit-flip pixels between them (chip_smoke.py)."""
    from surfjax.core.camera import flat_camera_rays
    from surfjax.pipeline.frame import render_rays

    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics
    R0 = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    t0 = jnp.asarray(np.asarray(camera.position, np.float32))
    R = _matmul9(rodrigues(jnp.asarray(w, jnp.float32)), R0)
    o, d, _ = flat_camera_rays(intr, R, t0 + jnp.asarray(dt, jnp.float32))
    if settings.backend == "pallas":
        from surfjax.diff.hybrid import render_rays_hybrid
        fb = jax.jit(lambda p, o, d: render_rays_hybrid(
            static, settings, p, o, d))(params, o, d)
    else:
        fb = jax.jit(lambda p, o, d: render_rays(
            static, settings, p, o, d))(params, o, d)
    return np.asarray(fb.hit).reshape(intr.height, intr.width) > 0.5


def fit_sdf(scene, camera, target_rgb, steps: int = 200, lr: float = 1e-2,
            settings: RenderSettings = RenderSettings(),
            param_mask: Optional[np.ndarray] = None,
            init_leaf_params: Optional[np.ndarray] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50,
            verbose: bool = False):
    """Recover SDF leaf parameters that produced `target_rgb`.

    Optimizes params['leaf_params'] (optionally masked to a subset),
    starting from `init_leaf_params` if given (else the scene's own).
    Returns (fitted leaf_params array, losses list).
    """
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    if init_leaf_params is not None:
        params["leaf_params"] = jnp.asarray(init_leaf_params, jnp.float32)
    intr = camera.intrinsics
    R0 = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    t0 = jnp.asarray(np.asarray(camera.position, np.float32))
    target = jnp.asarray(target_rgb, jnp.float32)
    lp0 = params["leaf_params"]
    mask = (jnp.asarray(param_mask, jnp.float32) if param_mask is not None
            else jnp.ones_like(lp0))

    def loss_fn(lp):
        p = dict(params, leaf_params=lp0 + (lp - lp0) * mask)
        rgb = _frame_rgb(static, intr, settings, p, R0, t0)
        diff = rgb - target
        return jnp.mean(diff * diff)

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    lp = lp0
    state = opt.init(lp)

    @jax.jit
    def step(lp, state):
        loss, g = jax.value_and_grad(loss_fn)(lp)
        updates, state = opt.update(g, state)
        return optax.apply_updates(lp, updates), state, loss

    start = 0
    if checkpoint_path is not None:
        import os
        from surfjax.utils.checkpoint import load_fit_state, save_fit_state
        if os.path.exists(checkpoint_path):
            start, lp, state = load_fit_state(checkpoint_path, lp, state)
    losses = []
    for i in range(start, steps):
        lp, state, loss = step(lp, state)
        losses.append(float(loss))
        if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
            save_fit_state(checkpoint_path, i + 1, lp, state)
        if verbose and i % 20 == 0:
            print(f"fit_sdf step {i}: loss {losses[-1]:.6g}")
    lp = lp0 + (lp - lp0) * mask
    return np.asarray(lp), losses
