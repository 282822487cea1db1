"""CLI (SURVEY.md §1 L7 / §2 component 23).

    python -m surfjax render --config configs/c1_sphere.yaml --out frame.png
    python -m surfjax render --config ... --golden        # NumPy oracle path
    python -m surfjax animate --config configs/c5_anim.yaml --out-dir frames/
    python -m surfjax bench  --config configs/c3_sdf.yaml
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load(args):
    from surfjax.config import load_config
    return load_config(args.config)


def cmd_render(args):
    scene, camera, settings, _extras = _load(args)
    if args.backend:
        settings = settings.with_(backend=args.backend)
    from surfjax.io.image import save_png, save_golden
    if args.golden:
        from surfjax.golden import renderer as golden
        t0 = time.time()
        fb = golden.render_parallel(scene, camera, settings)
        dt = time.time() - t0
        rgb, depth, normal = fb["rgb"], fb["depth"], fb["normal"]
    else:
        import jax
        from surfjax import render
        from surfjax.utils.profiling import trace_render
        t0 = time.time()
        with trace_render(args.profile_dir):
            fb = jax.block_until_ready(render(scene, camera, settings))
        dt = time.time() - t0
        rgb = np.asarray(fb.rgb)
        depth = np.asarray(fb.depth)
        normal = np.asarray(fb.normal)
    print(f"rendered {rgb.shape[1]}x{rgb.shape[0]} in {dt:.3f}s "
          f"({'golden' if args.golden else settings.backend})")
    if args.out.lower().endswith(".exr"):
        # linear float32 out — no tonemap (EXR is the HDR path)
        from surfjax.io.image import save_exr
        save_exr(args.out, rgb)
    else:
        save_png(args.out, rgb)
    if args.gbuffer:
        base, _ = os.path.splitext(args.out)
        save_golden(base + "_gbuffer.npz",
                    {"rgb": rgb, "depth": depth, "normal": normal})
        print(f"wrote {base}_gbuffer.npz")
    print(f"wrote {args.out}")


def cmd_animate(args):
    import jax
    import jax.numpy as jnp
    from surfjax import render_sequence
    from surfjax.core.camera import orbit_pose
    from surfjax.io.image import save_png

    scene, camera, settings, extras = _load(args)
    if args.backend:
        settings = settings.with_(backend=args.backend)
    anim = extras.get("animation") or {
        "type": "orbit", "frames": 16, "radius": 4.0, "height": -1.0}
    n = int(anim.get("frames", 16) if args.frames is None
            else args.frames)
    thetas = jnp.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    Rs, ts = jax.vmap(lambda th: orbit_pose(
        jnp.float32(anim.get("radius", 4.0)),
        jnp.float32(anim.get("height", -1.0)), th))(thetas)
    center = np.asarray(anim.get("center", (0, 0, 0)), np.float32)
    ts = ts + jnp.asarray(center)
    t0 = time.time()
    if args.chunk_size:
        # chunked render with checkpoint/resume (SURVEY.md §5.4a): rerun
        # the same command after an interruption and it skips done chunks
        from surfjax.utils.checkpoint import SequenceCheckpointer
        cp = SequenceCheckpointer(args.out_dir, chunk_size=args.chunk_size)

        def render_chunk(start, count):
            fb = render_sequence(
                scene, camera,
                (Rs[start:start + count], ts[start:start + count]),
                settings)
            return np.asarray(fb.rgb)

        cp.render_all(n, render_chunk)
        # n arms the stale-chunk contiguity validation (a previous
        # longer run in the same out_dir must not leak extra frames)
        rgb = cp.load_all(n)
    else:
        frames = jax.block_until_ready(
            render_sequence(scene, camera, (Rs, ts), settings))
        rgb = np.asarray(frames.rgb)
    dt = time.time() - t0
    print(f"rendered {n} frames on-device in {dt:.3f}s "
          f"({n / dt:.2f} frames/s)")
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(n):
        save_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"), rgb[i])
    print(f"wrote {n} PNGs to {args.out_dir}")


def cmd_bench(args):
    from bench import run_bench
    result = run_bench(config=args.config, repeats=args.repeats)
    print(json.dumps(result))


def cmd_fit(args):
    """Inverse-rendering demo (BASELINE.json:11): render a target with the
    config's true parameters, perturb, then recover them."""
    import jax
    import numpy as np
    from surfjax.diff import fit_pose, fit_sdf
    from surfjax.pipeline.frame import render_frame

    scene, camera, settings, extras = _load(args)
    if args.backend:
        settings = settings.with_(backend=args.backend)
    fit_cfg = extras.get("fit", {})
    mode = args.mode or fit_cfg.get("type", "pose")
    steps = (int(fit_cfg.get("steps", 100)) if args.steps is None
             else args.steps)
    lr = float(fit_cfg.get("lr", 2e-2))

    target = np.asarray(render_frame(scene, camera, settings).rgb)
    t0 = time.time()
    if mode == "pose":
        init = (np.asarray([0.05, -0.04, 0.03], np.float32),
                np.asarray([0.05, -0.05, 0.0], np.float32))
        R, t, losses = fit_pose(scene, camera, target, steps=steps, lr=lr,
                                settings=settings, init=init, verbose=True)
        print(f"fit_pose: loss {losses[0]:.3e} -> {losses[-1]:.3e} "
              f"in {time.time() - t0:.1f}s")
        print("recovered R:\n", R.reshape(3, 3).round(4))
        print("recovered t:", t.round(4))
    elif mode == "sdf":
        # perturb the SDF objects' leaf parameters, then recover them
        # (analytic planes + hard-shadow boundaries carry no useful
        # gradient — standard visibility-gradient limitation)
        from surfjax.core.scene_compile import ENGINE_SDF
        static, true_params = scene.freeze()
        init = np.array(true_params["leaf_params"], np.float32)
        mask = np.zeros_like(init)
        for oir in static.ir.objects:
            if oir.engine == ENGINE_SDF:
                for lf in oir.leaves:
                    mask[lf.slot, :4] = 1.0
        rng = np.random.default_rng(0)
        init += (rng.normal(0, 0.05, init.shape) * mask).astype(np.float32)
        lp, losses = fit_sdf(scene, camera, target, steps=steps, lr=lr,
                             settings=settings, init_leaf_params=init,
                             param_mask=mask, verbose=True)
        err0 = np.abs(init - true_params["leaf_params"]).max()
        err1 = np.abs(lp - true_params["leaf_params"]).max()
        print(f"fit_sdf: loss {losses[0]:.3e} -> {losses[-1]:.3e}, "
              f"param err {err0:.4f} -> {err1:.4f} "
              f"in {time.time() - t0:.1f}s")
    else:
        raise SystemExit(f"unknown fit mode {mode!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="surfjax")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame from a config")
    pr.add_argument("--config", required=True)
    pr.add_argument("--out", default="frame.png")
    pr.add_argument("--golden", action="store_true",
                    help="use the NumPy golden oracle")
    pr.add_argument("--backend", choices=("jnp", "pallas"), default=None)
    pr.add_argument("--gbuffer", action="store_true",
                    help="also dump depth/normal G-buffer npz")
    pr.add_argument("--profile-dir", default=None,
                    help="dump a jax profiler trace here")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render an animated camera path")
    pa.add_argument("--config", required=True)
    pa.add_argument("--out-dir", default="frames")
    pa.add_argument("--frames", type=int, default=None)
    pa.add_argument("--chunk-size", type=int, default=None,
                    help="chunked render with checkpoint/resume")
    pa.add_argument("--backend", choices=("jnp", "pallas"), default=None)
    pa.set_defaults(fn=cmd_animate)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--config", default=None)
    pb.add_argument("--repeats", type=int, default=5)
    pb.set_defaults(fn=cmd_bench)

    pf = sub.add_parser("fit", help="inverse-rendering demo (pose/sdf)")
    pf.add_argument("--config", required=True)
    pf.add_argument("--mode", choices=("pose", "sdf"), default=None)
    pf.add_argument("--steps", type=int, default=None)
    pf.add_argument("--backend", choices=("jnp", "pallas"), default=None)
    pf.set_defaults(fn=cmd_fit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
