"""Image / G-buffer I/O (SURVEY.md §2 component 22).

PNG for human viewing; float32 .npy for golden frames (PNG quantizes away
ULP fidelity — SURVEY.md §4.1).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def tonemap_u8(rgb: np.ndarray) -> np.ndarray:
    """Linear -> sRGB-ish gamma 2.2, clipped to u8. NaN pixels map to 0
    deterministically (np.clip propagates NaN and float->uint8 casts of
    NaN are platform-defined garbage)."""
    x = np.nan_to_num(np.asarray(rgb, np.float32), nan=0.0,
                      posinf=1.0, neginf=0.0)
    x = np.clip(x, 0.0, 1.0)
    x = x ** (1.0 / 2.2)
    return (x * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, rgb) -> None:
    """8-bit RGB PNG (tonemapped), written with the standard library:
    one IDAT of zlib-compressed scanlines, filter type 0 on each."""
    import struct
    import zlib
    arr = tonemap_u8(np.asarray(rgb))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def save_exr(path: str, channels) -> None:
    """Minimal self-contained OpenEXR v2 writer (float32, scanline,
    uncompressed) — no external EXR library in this environment, and the
    format's uncompressed profile is simple enough to emit directly.

    channels: (H, W, 3) array (written as R/G/B) or a dict
    {name: (H, W) float32} (e.g. {"Z": depth}). Readable by any
    EXR-compliant tool (verified against the spec's layout: magic,
    v2 header attributes, chlist sorted bytewise, uint64 line-offset
    table, per-scanline [y, size, channel-planar rows])."""
    import struct

    arr = channels
    if not isinstance(arr, dict):
        a = np.asarray(arr, np.float32)
        if a.ndim != 3 or a.shape[-1] != 3:
            raise ValueError("save_exr expects (H, W, 3) or a dict")
        arr = {"R": a[..., 0], "G": a[..., 1], "B": a[..., 2]}
    names = sorted(arr)  # EXR requires bytewise-sorted channel order
    planes = [np.ascontiguousarray(np.asarray(arr[n], np.float32))
              for n in names]
    H, W = planes[0].shape
    if any(p.shape != (H, W) for p in planes):
        raise ValueError("EXR channels must share one (H, W)")

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return (name + b"\x00" + typ + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chlist = b""
    for n in names:
        # name, pixel type 2 = FLOAT, pLinear + 3 reserved, sampling 1,1
        chlist += (n.encode() + b"\x00" + struct.pack("<i", 2)
                   + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chlist += b"\x00"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = (attr(b"channels", b"chlist", chlist)
              + attr(b"compression", b"compression", b"\x00")
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\x00")
              + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
              + attr(b"screenWindowCenter", b"v2f",
                     struct.pack("<ff", 0.0, 0.0))
              + attr(b"screenWindowWidth", b"float",
                     struct.pack("<f", 1.0))
              + b"\x00")
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    row_bytes = 8 + 4 * W * len(names)  # [y, size] + planar channel rows
    table_start = len(magic) + len(header)
    data_start = table_start + 8 * H
    offsets = struct.pack("<%dQ" % H,
                          *(data_start + y * row_bytes for y in range(H)))
    with open(path, "wb") as fh:
        fh.write(magic)
        fh.write(header)
        fh.write(offsets)
        for y in range(H):
            fh.write(struct.pack("<ii", y, 4 * W * len(names)))
            for p in planes:
                fh.write(p[y].tobytes())


def save_golden(path: str, buffers: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in buffers.items()})


def load_golden(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def ulp_diff_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise distance in ULPs between two float32 arrays.

    Uses the monotonic integer mapping of IEEE-754 floats (sign-magnitude ->
    two's-complement ordering), so the result counts representable floats
    between a and b. Identical values -> 0; adjacent floats -> 1.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return np.abs(ai - bi)


def max_ulp(a, b) -> int:
    return int(ulp_diff_f32(a, b).max())
