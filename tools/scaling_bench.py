"""Weak/strong-scaling evidence for the sharded render path (SURVEY §2.2).

Runs render_sequence_sharded over a virtual N-device CPU mesh (the same
provisioning the test suite and the driver dryrun use) at several device
counts and reports frames/s plus the speedup curve. On a real multi-chip
machine the identical code paths shard over the device links; this tool
documents that the sharding itself scales, with the caveat that virtual CPU devices
share host cores, so the curve here mainly proves the collectives do not
serialize (watch for slowdowns, not linear speedup).

Usage: SCALE_DEVICES=8 python tools/scaling_bench.py [config] [size]
(re-execs itself under JAX_PLATFORMS=cpu with the forced device count).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _child():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from surfjax.config import load_config
    from surfjax.core.camera import Intrinsics
    from surfjax.parallel.mesh import make_mesh, render_sequence_sharded
    import dataclasses

    config = sys.argv[1] if len(sys.argv) > 1 else "configs/c3_sdf.yaml"
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    scene, camera, settings, _ = load_config(config)
    camera = dataclasses.replace(
        camera, intrinsics=Intrinsics.from_fov(size, size, 45.0))
    settings = settings.with_(max_steps=64)

    F = 4
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    R_flats = np.stack([R] * F)
    pos = np.asarray(camera.position, np.float32)
    positions = pos[None, :] + np.float32(1e-3) * np.arange(
        F, dtype=np.float32)[:, None]

    n_all = len(jax.devices())
    results = []
    for n in (1, 2, 4, n_all):
        if n > n_all or (results and n == results[-1][0]):
            continue
        n_frame = 2 if n >= 2 else 1
        mesh = make_mesh(n_frame=n_frame, n_tile=n // n_frame,
                         devices=jax.devices()[:n])
        fb = render_sequence_sharded(scene, camera, (R_flats, positions),
                                     settings, mesh=mesh)
        jax.block_until_ready(fb.rgb)
        t0 = time.perf_counter()
        for _ in range(3):
            fb = render_sequence_sharded(scene, camera,
                                         (R_flats, positions), settings,
                                         mesh=mesh)
            jax.block_until_ready(fb.rgb)
        dt = (time.perf_counter() - t0) / 3 / F
        results.append((n, dt))
        base = results[0][1]
        print(f"devices={n}  {dt * 1e3:8.2f} ms/frame  "
              f"speedup x{base / dt:.2f}")


def main():
    if os.environ.get("SCALING_CHILD"):
        _child()
        return
    n = int(os.environ.get("SCALE_DEVICES", "8"))
    env = dict(os.environ)
    env["SCALING_CHILD"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ""
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={n}"
                        ).strip()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__)]
                        + sys.argv[1:], env=env, cwd=_ROOT).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
