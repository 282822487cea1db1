"""2-process jax.distributed test (SURVEY.md §2.3 Init / §4.6; VERDICT r2
item 2).

Spawns two worker processes, each with 4 virtual CPU devices, that join
a jax.distributed cluster over localhost and render the fixture
animation sharded over the global (2 hosts x 4 devices) -> ('frame',
'tile') = (2, 4) mesh. The parent renders the same workload on its own
single-process 8-device mesh and asserts the outputs are bitwise
identical — the multi-process mesh runs the same per-shard programs, so
any difference is a distributed-runtime bug.

Skips cleanly if the CPU backend refuses distributed init (environment
without cross-process collective support).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_distributed_worker.py")
    out = str(tmp_path / "dist.npz")
    port = _free_port()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    # each worker's output goes to its own FILE, not a pipe: the two
    # workers are interlocked by collectives, so a worker blocked on a
    # full stdout pipe (while the parent reads the other) would stall
    # the whole cluster — a 9-minute flake under verbose logging
    logs = [tmp_path / f"worker{pid}.log" for pid in range(2)]
    handles = [open(lg, "w") for lg in logs]
    try:
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", str(port), out],
                env=env, stdout=handles[pid],
                stderr=subprocess.STDOUT, cwd=root)
            for pid in range(2)
        ]
        for p in procs:
            try:
                p.wait(timeout=540)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("distributed worker timed out")
    finally:
        # close (and flush) before reading the logs back (advisor r3)
        for h in handles:
            h.close()
    outputs = [lg.read_text() for lg in logs]
    refused = any(
        ("UNIMPLEMENTED" in o or "does not support" in o
         or "NotImplementedError" in o) for o in outputs)
    if any(p.returncode != 0 for p in procs):
        if refused:
            pytest.skip("backend refuses multi-process CPU collectives:\n"
                        + outputs[0][-2000:])
        pytest.fail("distributed worker failed:\n"
                    + "\n---\n".join(o[-3000:] for o in outputs))
    assert all("OK devices=8" in o for o in outputs), outputs

    # parent reference: same mesh shape on the single-process fake-8 backend
    import jax
    import jax.numpy as jnp
    from surfjax.core.camera import orbit_pose
    from surfjax.parallel import make_mesh, render_sequence_sharded
    from tests.scenes import config5_anim_scene

    scene, cam, settings = config5_anim_scene(size=32)
    settings = settings.with_(max_steps=32)
    F = 4
    thetas = jnp.linspace(0.0, 1.0, F)
    Rs, ts = jax.vmap(lambda th: orbit_pose(jnp.float32(4.0),
                                            jnp.float32(1.0), th))(thetas)
    ts = ts + jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
    ref = render_sequence_sharded(scene, cam, (Rs, ts), settings,
                                  make_mesh(n_frame=2, n_tile=4))

    with np.load(out) as z:
        np.testing.assert_array_equal(z["rgb"], np.asarray(ref.rgb))
        np.testing.assert_array_equal(z["depth"], np.asarray(ref.depth))
        np.testing.assert_array_equal(z["hit"], np.asarray(ref.hit))
