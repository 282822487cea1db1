#!/usr/bin/env python
"""Fit-loop throughput: jnp pipeline vs PALLAS HYBRID forward.

Measures pose-fit optimization steps/s at the c5 probe resolution
(configs/c5_anim.yaml, 256x256): one jitted Adam step =
value_and_grad(mse(render(pose), target)) + update, exactly fit_pose's
step. K steps are enqueued in a host loop and block_until_ready on the
last result is the sync point; reported steps/s therefore includes
dispatch, pipelined as a real fit runs. min over repeats.

Usage: python tools/fit_bench.py [steps] [repeats]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def bench_backend(backend: str, steps: int, repeats: int) -> dict:
    import jax
    import jax.numpy as jnp
    import optax
    from surfjax.config import load_config
    from surfjax.diff.fit import _frame_rgb, _matmul9, rodrigues

    scene, cam, settings, _ = load_config(
        os.path.join(_ROOT, "configs", "c5_anim.yaml"))
    settings = settings.with_(backend=backend)
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = cam.intrinsics
    R0 = jnp.asarray(np.asarray(cam.rotation, np.float32).reshape(9))
    t0 = jnp.asarray(np.asarray(cam.position, np.float32))
    # fixed target (same convention as the fidelity gate's probe): the
    # timing is target-independent
    target = jnp.full((intr.height, intr.width, 3), jnp.float32(0.5))

    def loss_fn(x):
        R = _matmul9(rodrigues(x["w"]), R0)
        rgb = _frame_rgb(static, intr, settings, params, R, t0 + x["dt"])
        diff = rgb - target
        return jnp.mean(diff * diff)

    opt = optax.adam(2e-2)
    x0 = {"w": jnp.asarray([0.02, -0.01, 0.015], jnp.float32),
          "dt": jnp.asarray([0.01, -0.02, 0.005], jnp.float32)}
    state0 = opt.init(x0)

    @jax.jit
    def step(x, state):
        loss, g = jax.value_and_grad(loss_fn)(x)
        updates, state = opt.update(g, state)
        return optax.apply_updates(x, updates), state, loss

    # warm-up / compile
    jax.block_until_ready(step(x0, state0))

    times = []
    for _ in range(repeats):
        x, state = x0, state0
        t_start = time.perf_counter()
        for _ in range(steps):
            x, state, loss = step(x, state)
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t_start)
    dt = float(np.min(times)) / steps
    return {"backend_setting": backend, "res": [intr.width, intr.height],
            "step_ms": round(dt * 1e3, 3),
            "steps_per_s": round(1.0 / dt, 3),
            "final_loss": float(loss)}


def main():
    import jax
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    print(f"backend: {jax.default_backend()}")
    rows = {}
    for be in ("jnp", "pallas"):
        r = bench_backend(be, steps, repeats)
        rows[be] = r
        print(f"| fit_pose {be:6s} | {r['step_ms']:9.2f} ms/step "
              f"| {r['steps_per_s']:8.2f} steps/s "
              f"| final loss {r['final_loss']:.6g} |", flush=True)
    if rows["jnp"]["step_ms"] and rows["pallas"]["step_ms"]:
        rows["speedup_pallas_vs_jnp"] = round(
            rows["jnp"]["step_ms"] / rows["pallas"]["step_ms"], 3)
        print(f"speedup pallas vs jnp: {rows['speedup_pallas_vs_jnp']}x")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
