"""The GPU route of the Pallas kernels, checked without a GPU.

Every kernel is a pallas_call on the Triton route. Here on the CPU the
kernels run in the interpreter (the rest of the suite); these tests pin
what the interpreter cannot show:

  - each kernel on the main path LOWERS to Triton for CUDA
    (jax.export with platforms=["cuda"] needs no card), so a primitive
    without a Triton lowering fails here, not on the card;
  - the route selection (interpreter on the CPU, Triton on the GPU,
    refusal elsewhere) and the launch parameters every call names;
  - the GPU rules on settings and the patch tiling of a frame.

One test needs the card itself (marker `gpu`, skips here).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

import surfjax.kernels.render_tile as rt
from surfjax.core.camera import Intrinsics
from surfjax.core.types import RenderSettings
from tests.scenes import config2_csg, config3_sdf, config4_mesh

TRITON_CALL = "__gpu$xla.gpu.triton"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def triton_route(monkeypatch):
    """Trace kernels as compiled Triton calls (not interpreted) with
    fresh jit caches, so no interpreted trace is reused."""
    jax.clear_caches()
    monkeypatch.setattr(rt, "_interpret", lambda: False)
    yield
    jax.clear_caches()


def _lower_cuda(fn, *args) -> str:
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            TRITON_CALL)])(*args)
    return exp.mlir_module()


def _frame_args(scene, cam, settings, size=(32, 16)):
    from surfjax.pipeline.frame import _frame_jit
    cam = dataclasses.replace(cam, intrinsics=Intrinsics.from_fov(
        size[0], size[1], 45.0))
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    R = jnp.asarray(np.asarray(cam.rotation, np.float32).reshape(9))
    t = jnp.asarray(np.asarray(cam.position, np.float32))
    intr = cam.intrinsics

    def fn(p, R, t):
        return _frame_jit(static, intr, settings.with_(backend="pallas"),
                          p, R, t).rgb
    return fn, (params, R, t)


def _crowd_scene():
    from surfjax.config import load_config
    scene, cam, settings, _ = load_config(
        os.path.join(ROOT, "configs", "crowd_demo.yaml"))
    return scene, cam, settings


def _c4_scene():
    scene, cam, settings = config4_mesh(width=32, height=16)
    return scene, cam, settings


FRAME_CASES = {
    # fused frame kernel (KF): analytic CSG + two lights
    "kf_c2": (lambda: config2_csg(size=32), {}),
    # KF: Mandelbulb + blob, soft shadows + AO (K2's penumbra core)
    "kf_c3": (lambda: config3_sdf(size=32),
              {"soft_shadows": True, "ao": True}),
    # KF with the crowd fori_loops (dynamic member-table reads)
    "kf_crowd": (_crowd_scene, {}),
    # split pipeline: K1 + mesh packet kernel + K2 hard shadows
    "split_c4": (_c4_scene, {}),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_lowers_to_triton(case, triton_route):
    build, overrides = FRAME_CASES[case]
    scene, cam, settings = build()
    fn, args = _frame_args(scene, cam, settings.with_(**overrides))
    txt = _lower_cuda(fn, *args)
    assert txt.count(TRITON_CALL) >= 1, case


def test_sequence_lowers_to_triton(triton_route):
    """The F-frame sequence form of KF: one Triton call for all frames."""
    from surfjax.pipeline.frame import _sequence_jit
    scene, cam, settings = config3_sdf(size=16)
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = Intrinsics.from_fov(32, 16, 45.0)
    st = settings.with_(backend="pallas")
    R = jnp.asarray(np.asarray(cam.rotation, np.float32).reshape(1, 9))
    pos = jnp.asarray(np.asarray(cam.position, np.float32))
    Rs = jnp.concatenate([R, R])
    ps = jnp.stack([pos, pos + 0.01])
    txt = _lower_cuda(lambda p, Rs, ps: _sequence_jit(
        static, intr, st, p, Rs, ps).rgb, params, Rs, ps)
    assert txt.count(TRITON_CALL) == 1


def test_k2_soft_and_ao_fix_lower_to_triton(triton_route):
    """K2 (soft-shadow visibility) and the AO fix-up kernel, called
    directly on (8, 128) ray blocks."""
    scene, cam, settings = config3_sdf(size=16)
    st = settings.with_(backend="pallas", soft_shadows=True, ao=True)
    static, params = scene.freeze()
    lp = jnp.asarray(params["leaf_params"])
    nparams = jnp.asarray(params["node_params"])
    a = jnp.zeros((8, rt.LANES), jnp.float32)
    one = jnp.ones_like(a)
    txt = _lower_cuda(
        lambda lp, nparams, a, one: rt.trace_rays_kernel(
            static, st, lp, nparams, (a, a + 1.0, a), (a, one, a), one,
            one * 8.0), lp, nparams, a, one)
    assert txt.count(TRITON_CALL) == 1
    txt = _lower_cuda(
        lambda lp, nparams, a, one: rt.ao_fix_kernel(
            static, st, lp, nparams, (a, a, a + 3.0), (a, one, a), one, a),
        lp, nparams, a, one)
    assert txt.count(TRITON_CALL) == 1


def test_mesh_overflow_variant_lowers_to_triton(triton_route, monkeypatch):
    """Both packet-kernel variants (with and without the full-table
    overflow scan) lower when tiles can overflow the candidate budget."""
    from surfjax.kernels import mesh_tile
    monkeypatch.setattr(mesh_tile, "PACKET_K", 8)
    scene, cam, settings = _c4_scene()
    fn, args = _frame_args(scene, cam, settings)
    txt = _lower_cuda(fn, *args)
    # K1 + 2 mesh variants (primary) + K2 + 2 mesh variants (shadow)
    assert txt.count(TRITON_CALL) >= 6


@pytest.mark.parametrize("platform,interpret", [
    ("cpu", True), ("gpu", False), ("rocm", None), ("metal", None)])
def test_route_selection(platform, interpret, monkeypatch):
    monkeypatch.setattr(rt.jax, "default_backend", lambda: platform)
    if interpret is None:
        with pytest.raises(RuntimeError, match="pallas backend runs on"):
            rt._interpret()
    else:
        assert rt._interpret() is interpret


@pytest.mark.parametrize("tile_rows", [1, 2, 4, 8])
def test_every_call_names_the_triton_route(tile_rows, monkeypatch):
    from jax.experimental.pallas import triton as plt
    seen = {}

    def fake_pallas_call(body, **kw):
        seen.update(kw)
        return "call"

    monkeypatch.setattr(rt.pl, "pallas_call", fake_pallas_call)
    assert rt._pallas(None, grid=(1,), in_specs=[], out_specs=(),
                      out_shape=(), tile_rows=tile_rows) == "call"
    assert seen["backend"] == "triton"
    cp = seen["compiler_params"]
    assert isinstance(cp, plt.CompilerParams)
    # one ray per thread up to 8 warps
    assert cp.num_warps == min(tile_rows * rt.LANES // 32, 8)
    assert cp.num_stages == 1
    assert seen["interpret"] is True  # this suite runs on the CPU


@pytest.mark.parametrize("tile_rows,ok", [
    (1, True), (2, True), (4, True), (8, True),
    (0, False), (3, False), (12, False), (16, False)])
def test_validate_pallas_settings_gpu_rules(tile_rows, ok):
    """Triton blocks are powers of two; above 8 rows (1,024 rays) a
    block would hold more than four rays per thread."""
    s = RenderSettings(backend="pallas", tile_rows=tile_rows)
    if ok:
        rt._validate_pallas_settings(s)
    else:
        with pytest.raises(ValueError, match="power of two"):
            rt._validate_pallas_settings(s)


@pytest.mark.parametrize("tile_rows", [1, 2, 4, 8])
def test_frame_tiles_roundtrip(tile_rows):
    """Each block of tile_rows x 128 rays is one pixel patch; tiling an
    image (edge-padded to whole patches) and untiling it is exact."""
    intr = Intrinsics.from_fov(53, 37, 45.0)
    tiles = rt.frame_tiles(intr, tile_rows)
    th, tw = rt.tile_shape(tile_rows)
    assert th * tw == tile_rows * rt.LANES
    assert tiles.ty * th >= 37 and tiles.tx * tw >= 53
    img = np.arange(tiles.ty * th * tiles.tx * tw, dtype=np.float32)
    img = img.reshape(tiles.ty * th, tiles.tx * tw)
    blocks = tiles.tile(jnp.asarray(img))
    assert blocks.shape == (tiles.rows_total, rt.LANES)
    # block 0 holds the top-left patch in row-major order
    np.testing.assert_array_equal(
        np.asarray(blocks[:tile_rows]).reshape(th, tw), img[:th, :tw])
    back = tiles.untile(blocks, 37, 53)
    np.testing.assert_array_equal(np.asarray(back), img[:37, :53])


def test_smoke_check_flags_each_tolerance():
    """chip_smoke.py's parity gate fails on every metric past its
    tolerance (and on non-finite output), and passes within it."""
    import sys
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    rgb = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    hit = np.ones((16, 16), np.float32)
    cs.FAILURES.clear()
    m = cs.image_metrics(rgb, hit, rgb, hit)
    assert m["hit_agree"] == 1.0 and m["q99"] == 0.0 and m["gross"] == 0.0
    assert cs.check("same", m, cs.TOL["c2"], "test")
    bad = rgb.copy()
    bad[0, 0] += 0.5
    bad[1, :] = np.nan
    hit2 = hit.copy()
    hit2[2, :4] = 0.0
    m2 = cs.image_metrics(bad, hit2, rgb, hit)
    assert not cs.check("bad", m2, cs.TOL["c2"], "test")
    assert cs.FAILURES and "non-finite" in cs.FAILURES[-1]
    assert "hit_agree" in cs.FAILURES[-1] and "gross" in cs.FAILURES[-1]
    cs.FAILURES.clear()


@pytest.mark.gpu
def test_compiled_kernels_match_jnp_on_card(gpu_device):
    """On the card: the compiled Triton frame kernel agrees with the
    plain XLA path on the analytic CSG scene (rounding only)."""
    from surfjax import render
    scene, cam, settings = config2_csg(size=128)
    fb_p = render(scene, cam, settings.with_(backend="pallas"))
    fb_j = render(scene, cam, settings.with_(backend="jnp"))
    assert (np.asarray(fb_p.hit) == np.asarray(fb_j.hit)).mean() > 0.9999
    d = np.abs(np.asarray(fb_p.rgb) - np.asarray(fb_j.rgb))
    assert np.quantile(d, 0.99) < 5e-5
