"""YAML scene/config loader (SURVEY.md §2 component 23, §5.6).

Schema (see configs/*.yaml for the five SPEC configs, BASELINE.json:7-11):

    camera:   {width, height, fov, position, target?, up?}
    settings: {any RenderSettings field}
    objects:  [{node: <node>, material: <mat>, engine?: analytic|sdf|mesh}]
    lights:   [{type: point|directional, ...}]
    animation?: {type: orbit, frames, radius, height}

    <node>: {type: sphere|plane|box|mandelbulb|mesh |
                   union|intersect|subtract|smooth_union|smooth_intersect|
                   smooth_subtract, ...}
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

from surfjax import api
from surfjax.core.types import RenderSettings


_CONFIG_DIR = [None]  # set by load_config for config-relative obj paths


# ---------------------------------------------------------------------------
# The YAML subset the configs are written in, parsed without a YAML
# library: block mappings and "- " sequences by indentation, flow {...}
# and [...] collections (which may span lines), "#" comments, and plain
# or quoted scalars (int, float, true/false, null, else a string).
# ---------------------------------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][\w\-]*)\s*:(?:\s+|$)")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(tok: str):
    t = tok.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    if t in ("", "~", "null"):
        return None
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    return t


def _skip(s: str, i: int) -> int:
    while i < len(s) and s[i].isspace():
        i += 1
    return i


def _flow(s: str, i: int):
    """One flow value of s starting at i -> (value, index after it)."""
    i = _skip(s, i)
    if s[i] in "{[":
        close = "}" if s[i] == "{" else "]"
        out = {} if close == "}" else []
        i = _skip(s, i + 1)
        while s[i] != close:
            if close == "}":
                j = s.index(":", i)
                out[_scalar(s[i:j])], i = _flow(s, j + 1)
            else:
                val, i = _flow(s, i)
                out.append(val)
            i = _skip(s, i)
            if s[i] == ",":
                i = _skip(s, i + 1)
        return out, i + 1
    j = i
    while j < len(s) and s[j] not in ",]}":
        j += 1
    return _scalar(s[i:j]), j


def _inline(text: str):
    if text[:1] in "{[":
        val, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"unexpected text after {text[:end]!r}")
        return val
    return _scalar(text)


def _logical_lines(text: str):
    """-> [(indent, content)], comments dropped, a flow collection that
    spans lines joined into one."""
    out, pending = [], None
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
        elif line.strip():
            pending = (len(line) - len(line.lstrip(" ")), line.strip())
        else:
            continue
        c = pending[1]
        if c.count("{") + c.count("[") <= c.count("}") + c.count("]"):
            out.append(pending)
            pending = None
    if pending is not None:
        raise ValueError(f"unclosed flow collection: {pending[1]!r}")
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, i: int, indent: int):
    """The block node whose first line is lines[i], at this indent
    -> (value, index of the first line after it)."""
    if _is_item(lines[i][1]):
        seq = []
        while (i < len(lines) and lines[i][0] == indent
               and _is_item(lines[i][1])):
            rest = lines[i][1][1:].strip()
            if not rest:
                val, i = _block(lines, i + 1, lines[i + 1][0])
            elif _KEY.match(rest):
                # a mapping that starts on the dash line: its keys sit
                # at the column where `rest` starts
                col = indent + len(lines[i][1]) - len(rest)
                lines[i] = (col, rest)
                val, i = _block(lines, i, col)
            else:
                val, i = _inline(rest), i + 1
            seq.append(val)
        return seq, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        m = _KEY.match(lines[i][1])
        if not m:
            raise ValueError(f"expected 'key:' at {lines[i][1]!r}")
        key, rest = m.group(1), lines[i][1][m.end():].strip()
        i += 1
        if rest:
            out[key] = _inline(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """Parse a config written in the YAML subset above."""
    lines = _logical_lines(text)
    if not lines:
        return None
    val, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return val


_NODE_KEYS = {
    "sphere": {"type", "center", "radius"},
    "plane": {"type", "normal", "offset"},
    "box": {"type", "center", "half_extents"},
    "mandelbulb": {"type", "center", "scale", "power", "iterations",
                   "bailout"},
    "mesh": {"type", "generate", "subdivisions", "obj", "scale",
             "translate", "smooth", "grid_res"},
    "union": {"type", "a", "b"}, "intersect": {"type", "a", "b"},
    "subtract": {"type", "a", "b"},
    "smooth_union": {"type", "a", "b", "k"},
    "smooth_intersect": {"type", "a", "b", "k"},
    "smooth_subtract": {"type", "a", "b", "k"},
}


def _node(d: dict) -> api.SceneNode:
    t = d["type"]
    # loud unknown-key validation, same policy as the settings block
    # (review r3: a typoed node key — or a real field like mandelbulb
    # bailout — was silently dropped)
    if t in _NODE_KEYS:
        unknown = set(d) - _NODE_KEYS[t]
        if unknown:
            raise ValueError(
                f"unknown keys for node type {t!r}: {sorted(unknown)}")
    if t == "sphere":
        return api.Sphere(tuple(d["center"]), float(d["radius"]))
    if t == "plane":
        return api.Plane(tuple(d["normal"]), float(d.get("offset", 0.0)))
    if t == "box":
        return api.Box(tuple(d["center"]), tuple(d["half_extents"]))
    if t == "mandelbulb":
        return api.Mandelbulb(tuple(d.get("center", (0, 0, 0))),
                              float(d.get("scale", 1.0)),
                              int(d.get("power", 8)),
                              int(d.get("iterations", 8)),
                              float(d.get("bailout", 2.0)))
    if t == "mesh":
        gen = d.get("generate")
        if gen == "octasphere":
            from surfjax.meshgen import octasphere
            v, f = octasphere(int(d.get("subdivisions", 2)))
        elif "obj" in d:
            import os
            path = d["obj"]
            if not os.path.isabs(path) and _CONFIG_DIR[0]:
                path = os.path.join(_CONFIG_DIR[0], path)
            v, f = load_obj(path)
        else:
            raise ValueError("mesh node needs generate: or obj:")
        v = np.asarray(v, np.float32) * float(d.get("scale", 1.0))
        v = v + np.asarray(d.get("translate", (0, 0, 0)), np.float32)
        return api.TriangleMesh(
            vertices=v, faces=f,
            grid_res=(tuple(d["grid_res"]) if "grid_res" in d else None),
            smooth=bool(d.get("smooth", True)))
    if t in ("union", "intersect", "subtract"):
        fn = {"union": api.union, "intersect": api.intersect,
              "subtract": api.subtract}[t]
        return fn(_node(d["a"]), _node(d["b"]))
    if t in ("smooth_union", "smooth_intersect", "smooth_subtract"):
        fn = {"smooth_union": api.smooth_union,
              "smooth_intersect": api.smooth_intersect,
              "smooth_subtract": api.smooth_subtract}[t]
        return fn(_node(d["a"]), _node(d["b"]), float(d["k"]))
    raise ValueError(f"unknown node type {t!r}")


def _material(d: dict) -> api.Material:
    t = d.get("type", "lambert")
    kw = {k: v for k, v in d.items() if k != "type"}
    for key in ("albedo", "specular_color"):
        if key in kw:
            kw[key] = tuple(kw[key])
    if t == "lambert":
        return api.Material.lambert(**kw)
    if t == "blinn_phong":
        return api.Material.blinn_phong(**kw)
    raise ValueError(f"unknown material type {t!r}")


def load_obj(path: str):
    """OBJ loader (v / f lines, triangulates fans). Uses the native C++
    parser (surfjax/native/obj_loader.cpp — memory-speed for production
    meshes); this Python walk is the no-toolchain fallback."""
    from surfjax.native import load_obj as native_load
    res = native_load(path)
    if res is not None:
        return res
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                # skip malformed short rows, matching obj_loader.cpp
                # (review r3: a 2-coord row made np.asarray ragged)
                if len(parts) < 4:
                    continue
                try:
                    row = [float(x) for x in parts[1:4]]
                except ValueError:
                    continue
                verts.append(row)
            elif parts[0] == "f":
                # OBJ indices are 1-based; negative = relative to the
                # vertex count so far (matching the native parser)
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def load_config(path: str):
    """-> (scene, camera, settings, extras dict)."""
    import os

    with open(path) as fh:
        cfg = parse_yaml(fh.read())
    _CONFIG_DIR[0] = os.path.dirname(os.path.abspath(path))

    scene = api.Scene()
    for od in cfg.get("objects", []):
        scene.add(_node(od["node"]),
                  _material(od.get("material", {})),
                  engine=od.get("engine"))
    for ld in cfg.get("lights", []):
        t = ld.get("type", "point")
        if t == "point":
            scene.add_light(api.PointLight(tuple(ld["position"]),
                                           tuple(ld.get("color", (1, 1, 1))),
                                           float(ld.get("radius", 0.0))))
        else:
            scene.add_light(api.DirectionalLight(
                tuple(ld["direction"]), tuple(ld.get("color", (1, 1, 1)))))

    c = cfg["camera"]
    camera = api.Camera.pinhole(int(c["width"]), int(c["height"]),
                                float(c.get("fov", 45.0)),
                                position=tuple(c.get("position", (0, 0, 0))),
                                target=(tuple(c["target"])
                                        if "target" in c else None),
                                up=tuple(c.get("up", (0, 1, 0))))

    s = cfg.get("settings", {})
    valid = {f.name for f in dataclasses.fields(RenderSettings)}
    unknown = set(s) - valid
    if unknown:
        raise ValueError(f"unknown settings: {sorted(unknown)}")
    if "background" in s:
        s["background"] = tuple(s["background"])
    settings = RenderSettings(**s)

    extras = {k: cfg[k] for k in ("animation", "fit") if k in cfg}
    return scene, camera, settings, extras
