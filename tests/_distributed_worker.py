"""Worker process for tests/test_distributed.py (SURVEY.md §2.3 Init row).

Run as:  python tests/_distributed_worker.py PROCESS_ID NPROCS PORT OUT.npz

Each worker joins a jax.distributed cluster over localhost (a
multi-process cluster on one host), brings 4
virtual CPU devices (set via env by the parent), builds the GLOBAL
('frame','tile') = (2, 4) mesh over all 8 devices, renders the fixture
animation with render_sequence_sharded, allgathers the global
framebuffers, and (process 0) saves them for the parent to compare
bitwise against its own single-process sharded render.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = int(sys.argv[3])
    out = sys.argv[4]

    import jax

    # the REAL multi-host init path (parallel/mesh.py::initialize_distributed)
    from surfjax.parallel.mesh import initialize_distributed
    initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 4 * nprocs, jax.device_count()

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

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

    mesh = make_mesh(n_frame=2, n_tile=4)  # spans BOTH processes
    fb = render_sequence_sharded(scene, cam, (Rs, ts), settings, mesh)

    # materialize the global result on every host (cross-process
    # allgather — actual cross-process collective traffic)
    rgb = multihost_utils.process_allgather(fb.rgb, tiled=True)
    depth = multihost_utils.process_allgather(fb.depth, tiled=True)
    hit = multihost_utils.process_allgather(fb.hit, tiled=True)
    if pid == 0:
        np.savez(out, rgb=np.asarray(rgb), depth=np.asarray(depth),
                 hit=np.asarray(hit))
    multihost_utils.sync_global_devices("surfjax_dist_test_done")
    print(f"worker {pid}: OK devices={jax.device_count()}")


if __name__ == "__main__":
    main()
