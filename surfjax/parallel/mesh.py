"""Sharding & communication layer (SURVEY.md §1 L1, §2.2/§2.3).

BASELINE.json:5 — frames shard over a device mesh by image tiles with no
inter-step host round-trips. Two data axes [SURVEY.md §2.2]:
  * 'tile'  — image tiles (flat ray ranges) within a frame;
  * 'frame' — frames of an animation batch [BASELINE.json:11].

All communication is XLA collectives (NCCL on GPUs) reached through
jax.sharding.Mesh + shard_map (SURVEY.md §2.3): the compiled ScenePack is
replicated (broadcast once), per-device framebuffer shards stay resident,
and the only cross-device traffic is the frame-end gather when the caller
fetches results. `jax.distributed.initialize` covers multi-host runs.

Inside shard_map, the march's early-exit reduction (`jnp.all(done)`) is
*per-shard*, so each device exits its own tiles as soon as they converge —
no global synchronization per step.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from surfjax.core.camera import Intrinsics, flat_camera_rays
from surfjax.core.types import FrameBuffers, RenderSettings
from surfjax.pipeline.frame import render_rays


def _render_fn(static, settings):
    """Per-shard renderer honoring settings.backend (each device runs its
    own Pallas kernels on its ray shard)."""
    if settings.backend == "pallas":
        from surfjax.kernels.render_tile import render_rays_pallas
        return lambda p, o, d: render_rays_pallas(static, settings, p, o, d)
    return lambda p, o, d: render_rays(static, settings, p, o, d)


def initialize_distributed(**kw) -> None:
    """Multi-host init (no-op on a single host / single slice)."""
    try:
        jax.distributed.initialize(**kw)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def make_mesh(n_frame: int = 1, n_tile: Optional[int] = None,
              devices=None) -> Mesh:
    """('frame', 'tile') device mesh. Defaults: all devices on 'tile'.
    Raises when the requested shape cannot be built (review r3: silently
    dropping devices or producing a zero-size axis surfaced as cryptic
    reshape errors deep in shard_map)."""
    devices = list(devices if devices is not None else jax.devices())
    if n_frame <= 0 or n_frame > len(devices):
        raise ValueError(
            f"n_frame={n_frame} must be in [1, {len(devices)}] "
            f"(available devices)")
    if n_tile is None:
        n_tile = len(devices) // n_frame
        if n_frame * n_tile != len(devices):
            raise ValueError(
                f"n_frame={n_frame} does not divide the device count "
                f"{len(devices)}; pass n_tile explicitly to use a "
                f"subset deliberately")
    if n_tile <= 0 or n_frame * n_tile > len(devices):
        raise ValueError(
            f"mesh shape ({n_frame}, {n_tile}) needs "
            f"{n_frame * n_tile} devices; have {len(devices)}")
    used = n_frame * n_tile
    return Mesh(np.asarray(devices[:used]).reshape(n_frame, n_tile),
                ("frame", "tile"))


# canonical flat raygen lives in core/camera.py (one definition for
# fit + sharded paths)
_flat_rays = flat_camera_rays


def _crop_reshape(fb: FrameBuffers, n: int, H: int, W: int) -> FrameBuffers:
    def fix(a, ch=None):
        a = a[:n] if a.ndim == 1 else a[:n, :]
        return a.reshape((H, W) if ch is None else (H, W, ch))
    return FrameBuffers(rgb=fix(fb.rgb, 3), depth=fix(fb.depth),
                        normal=fix(fb.normal, 3), hit=fix(fb.hit),
                        obj_id=fix(fb.obj_id))


@functools.lru_cache(maxsize=32)
def _sharded_frame_fn(static, settings, intr, mesh):
    """Jitted sharded-frame executable, cached on the static key so
    repeated per-frame calls reuse the compiled program (review r3: a
    per-call closure defeated jax.jit's cache)."""
    n_tile = mesh.shape["tile"] * mesh.shape["frame"]
    spec_rays = P(("frame", "tile"))  # fold both axes over the ray dim

    @jax.jit
    def run(params, R_flat, cam_pos):
        o, d, _ = _flat_rays(intr, R_flat, cam_pos, pad_to=n_tile)
        fn = shard_map(
            _render_fn(static, settings),
            mesh=mesh,
            in_specs=(P(), spec_rays, spec_rays),
            out_specs=FrameBuffers(rgb=spec_rays, depth=spec_rays,
                                   normal=spec_rays, hit=spec_rays,
                                   obj_id=spec_rays),
            check_vma=False,  # pallas outputs carry no varying-axis metadata
        )
        return fn(params, o, d)

    return run


def render_frame_sharded(scene, camera, settings: RenderSettings = RenderSettings(),
                         mesh: Optional[Mesh] = None) -> FrameBuffers:
    """One frame, image tiles sharded over the mesh's 'tile' axis."""
    mesh = mesh or make_mesh()
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics
    run = _sharded_frame_fn(static, settings, intr, mesh)
    R_flat = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    cam_pos = jnp.asarray(np.asarray(camera.position, np.float32))
    fb = run(params, R_flat, cam_pos)
    n = intr.width * intr.height
    return _crop_reshape(fb, n, intr.height, intr.width)


@functools.lru_cache(maxsize=32)
def _sharded_sequence_fn(static, settings, intr, mesh):
    """Jitted sharded-sequence executable, cached like _sharded_frame_fn
    (jax.jit then caches per pose-batch shape)."""
    n_frame = mesh.shape["frame"]
    n_tile = mesh.shape["tile"]

    @jax.jit
    def run(params, R_flats, positions):
        def per_device(p, Rs, ts):
            render_local = _render_fn(static, settings)

            def frame(R, t):
                o, d, _ = _flat_rays(intr, R, t, pad_to=n_tile)
                # rays on this device: shard manually by tile index
                ti = jax.lax.axis_index("tile")
                per = o[0].shape[0] // n_tile
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, ti * per, per)
                o_l = tuple(sl(c) for c in o)
                d_l = tuple(sl(c) for c in d)
                return render_local(p, o_l, d_l)
            return jax.vmap(frame)(Rs, ts)

        fn = shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P("frame"), P("frame")),
            out_specs=FrameBuffers(rgb=P("frame", "tile"),
                                   depth=P("frame", "tile"),
                                   normal=P("frame", "tile"),
                                   hit=P("frame", "tile"),
                                   obj_id=P("frame", "tile")),
            check_vma=False,  # pallas_call outputs carry no varying-axis metadata
        )
        return fn(params, R_flats, positions)

    return run


def render_sequence_sharded(scene, camera, poses,
                            settings: RenderSettings = RenderSettings(),
                            mesh: Optional[Mesh] = None):
    """Animation batch: frames shard over 'frame', rays over 'tile'
    [BASELINE.json:11] — fully on-device, one gather at the end."""
    mesh = mesh or make_mesh(n_frame=min(jax.device_count(), 2),
                             n_tile=jax.device_count()
                             // min(jax.device_count(), 2))
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics
    R_flats, positions = poses
    R_flats = jnp.asarray(R_flats, jnp.float32)
    positions = jnp.asarray(positions, jnp.float32)
    F = R_flats.shape[0]
    n_frame = mesh.shape["frame"]
    assert F % n_frame == 0, (
        f"frame count {F} must divide the 'frame' axis {n_frame}")
    run = _sharded_sequence_fn(static, settings, intr, mesh)
    fb = run(params, R_flats, positions)
    n = intr.width * intr.height
    H, W = intr.height, intr.width

    def fix(a, ch=None):
        a = a[:, :n] if a.ndim == 2 else a[:, :n, :]
        return a.reshape((F, H, W) if ch is None else (F, H, W, ch))

    return FrameBuffers(rgb=fix(fb.rgb, 3), depth=fix(fb.depth),
                        normal=fix(fb.normal, 3), hit=fix(fb.hit),
                        obj_id=fix(fb.obj_id))
