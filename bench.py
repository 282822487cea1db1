"""Benchmark harness (SURVEY.md §2 component 24).

Metric [BASELINE.json:2]: Mrays/sec/chip at 1080p (256-step trace);
frames/sec incl. shadow rays. Runs on a GPU only: on any other platform
it prints an error and exits 2, so no CPU number can pass for a device
number.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "Mrays/s/chip", "device_kind": ...}

THE metric workload (pinned — see BASELINE.md "Metric workload"):
configs/c3_sdf.yaml reframed to 1920x1080 at the config camera (same fov).

TWO fidelity modes are measured and reported every run:
  value        — the config's settings as-is (secondary-ray fractal LoD:
                 shadow marches truncate the Mandelbulb DE at
                 secondary_lod_iters, AO probes at ao_lod_iters;
                 conservative darkening — core/types.py).
  value_exact  — both LoDs 0 AND over_relax=1.0: full-DE secondary rays
                 on the oracle trajectory — exactly the settings the
                 golden parity tests compare against the oracles.
The three fields are read only by the Pallas kernels, so on
backend=jnp the two modes run the same program.

Methodology: N full frames are rendered inside ONE jitted dispatch via
the sequence path (camera position varies per frame to defeat caching);
the wall time of that dispatch, ended by block_until_ready, is divided
by N. For mesh-free scenes on backend=pallas this is the fused sequence
kernel (one pallas call, F x patches grid); otherwise a vmapped frame
pipeline. Ray accounting (SURVEY.md §5.5): primary = H*W; shadow = one
ray per (hit, light); AO = one probe ray per (hit, probe direction).

    python bench.py [config] [key=value ...]

key=value pairs override RenderSettings fields (e.g. backend=jnp) and
are disclosed in the JSON, except `repeats` and `n_frames`, which set
the harness.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


DEFAULT_CONFIG = "configs/c3_sdf.yaml"


def _time_mode(static, intr, settings, params, R_flat, positions,
               repeats: int):
    """-> (seconds per frame, hits per frame) for one settings variant."""
    import jax
    import jax.numpy as jnp
    from surfjax.pipeline.frame import _sequence_jit

    n_frames = positions.shape[0]

    @jax.jit
    def run_scan(params, R_flat, positions):
        F = positions.shape[0]
        R_flats = jnp.broadcast_to(R_flat[None, :], (F, 9))
        fb = _sequence_jit(static, intr, settings, params, R_flats,
                           positions)
        return fb.rgb.mean(), fb.depth.mean(), fb.hit.sum()

    # warm-up / compile
    acc = run_scan(params, R_flat, positions)
    n_hits = float(acc[2]) / n_frames

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run_scan(params, R_flat, positions))
        times.append(time.perf_counter() - t0)
    return float(np.min(times)) / n_frames, n_hits


def metric_workload(config: str | None = None, width: int = 1920,
                    height: int = 1080, n_frames: int = 48):
    """Build THE pinned metric workload (BASELINE.md): the config's scene
    reframed to width x height at the config camera's fov, with per-frame
    sub-pixel camera jitter (same workload, defeats result caching).
    -> (scene, static, params, intr, settings, R_flat, positions)."""
    import jax.numpy as jnp
    from surfjax.api import Camera
    from surfjax.config import load_config
    from surfjax.core.camera import Intrinsics

    scene, camera, settings, _ = load_config(config or DEFAULT_CONFIG)
    intr = camera.intrinsics
    if (intr.width, intr.height) != (width, height):
        fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
        camera = Camera(Intrinsics.from_fov(width, height, fov),
                        rotation=camera.rotation, position=camera.position)

    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = camera.intrinsics

    R_flat = jnp.asarray(np.asarray(camera.rotation, np.float32).reshape(9))
    pos0 = np.asarray(camera.position, np.float32)
    positions = jnp.asarray(
        pos0[None, :] + np.float32(1e-4) * np.arange(
            n_frames, dtype=np.float32)[:, None])
    return scene, static, params, intr, settings, R_flat, positions


def run_bench(config: str | None = None, repeats: int = 3,
              width: int = 1920, height: int = 1080,
              n_frames: int = 48, overrides: dict | None = None) -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX's first device is "
            f"{dev.platform!r}")
    scene, static, params, intr, settings, R_flat, positions = \
        metric_workload(config, width, height, n_frames)
    settings = settings.with_(backend="pallas")
    if overrides:
        settings = settings.with_(**overrides)

    dt, n_hits = _time_mode(static, intr, settings, params, R_flat,
                            positions, repeats)
    exact = settings.with_(secondary_lod_iters=0, ao_lod_iters=0,
                           over_relax=1.0)
    dt_exact, _ = _time_mode(static, intr, exact, params, R_flat,
                             positions, repeats)

    # ray accounting (SURVEY.md §5.5): primary = H*W; shadow = one ray
    # per (hit, light); AO = one probe per (hit, probe direction)
    primary = float(width * height)
    shadow = n_hits * len(scene.lights) if settings.shadows else 0.0
    ao = n_hits * settings.ao_samples if settings.ao else 0.0
    rpf = primary + shadow + ao
    n_dev = jax.local_device_count()
    return {
        "metric": ("Mrays/sec/chip at 1080p (256-step trace); "
                   "frames/sec incl. shadow rays"),
        "value": rpf / dt / 1e6,
        "unit": "Mrays/s/chip",
        "value_exact": rpf / dt_exact / 1e6,
        # composition check: the metric without AO probes (one 4-tap
        # probe per direction is far cheaper than a 256-step trace)
        "mrays_primary_shadow": (primary + shadow) / dt / 1e6,
        "mrays_primary_shadow_exact": (primary + shadow) / dt_exact / 1e6,
        # fidelity-mode disclosure for the headline `value`
        "secondary_lod_iters": settings.secondary_lod_iters,
        "ao_lod_iters": settings.ao_lod_iters,
        "over_relax": settings.over_relax,
        "bulb_iter": settings.bulb_iter,
        "frames_per_sec": 1.0 / dt,
        "rays_per_frame": int(rpf),
        "primary_rays": int(primary),
        "shadow_rays": int(shadow),
        "ao_rays": int(ao),
        "frame_time_s": dt,
        "frame_time_exact_s": dt_exact,
        "frames_per_dispatch": n_frames,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "devices": n_dev,
        "settings_backend": settings.backend,
        **({"overrides": {k: str(v) for k, v in overrides.items()}}
           if overrides else {}),
    }


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU; JAX's first device is "
              f"{dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    config = None
    overrides = {}
    harness = {"repeats": 3, "n_frames": 48}
    for a in sys.argv[1:]:
        if "=" in a:
            k, v = a.split("=", 1)
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    v = {"true": True, "false": False}.get(v.lower(), v)
            if k in harness:
                harness[k] = int(v)
            else:
                overrides[k] = v
        else:
            config = a
    result = run_bench(config=config, overrides=overrides or None,
                       **harness)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
