"""surfjax — a differentiable surface renderer built from scratch in JAX/XLA/Pallas.

Capability parity target: fmannan/surf_renderer (see SURVEY.md; the reference
mount was empty in every session so far — BASELINE.json is the authoritative
spec, per SURVEY.md §0).

Public API (SURVEY.md §1 L6 / §2 component 20):
    Scene, Camera, Material, PointLight, DirectionalLight,
    Sphere, Plane, Box, Mandelbulb, TriangleMesh,
    union, intersect, subtract, smooth_union, smooth_intersect, smooth_subtract,
    render, render_sequence, RenderSettings
"""

from surfjax.utils.compile_cache import enable_persistent_cache as \
    _enable_persistent_cache

# Persistent XLA compile cache (utils/compile_cache.py);
# SURFJAX_COMPILE_CACHE=off disables.
_enable_persistent_cache()

from surfjax.api import (
    Scene,
    Camera,
    Material,
    PointLight,
    DirectionalLight,
    Sphere,
    Plane,
    Box,
    Mandelbulb,
    TriangleMesh,
    union,
    intersect,
    subtract,
    smooth_union,
    smooth_intersect,
    smooth_subtract,
    render,
    render_sequence,
)
from surfjax.core.types import RenderSettings, FrameBuffers

__version__ = "0.1.0"

__all__ = [
    "Scene", "Camera", "Material", "PointLight", "DirectionalLight",
    "Sphere", "Plane", "Box", "Mandelbulb", "TriangleMesh",
    "union", "intersect", "subtract",
    "smooth_union", "smooth_intersect", "smooth_subtract",
    "render", "render_sequence", "RenderSettings", "FrameBuffers",
]
