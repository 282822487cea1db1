"""Image I/O (SURVEY §2 component 22). The RGB EXR layout walk lives in
tests/test_utils.py::test_exr_writer_layout_roundtrip; this file covers
what that one does not: named-channel (G-buffer style) EXR data round
trips through an independent mini-reader, PNG/golden-npz round trips,
and the ULP comparison utilities."""

import os
import struct

import numpy as np

from surfjax.io.image import (
    load_golden, max_ulp, save_exr, save_golden, save_png, tonemap_u8,
    ulp_diff_f32,
)


def _read_exr(path):
    """Minimal independent EXR v2 reader for the uncompressed scanline
    profile save_exr emits. Shares no code with the writer."""
    with open(path, "rb") as fh:
        raw = fh.read()
    magic, version = struct.unpack_from("<II", raw, 0)
    assert magic == 20000630, hex(magic)
    assert version & 0xFF == 2
    pos = 8
    attrs = {}
    while raw[pos] != 0:
        e = raw.index(b"\x00", pos)
        name = raw[pos:e].decode()
        pos = e + 1
        e = raw.index(b"\x00", pos)
        typ = raw[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = (typ, raw[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    # channel list: [name\0 i32 type, 4 bytes, i32 xs, i32 ys]* \0
    ch = attrs["channels"][1]
    names = []
    cpos = 0
    while ch[cpos] != 0:
        e = ch.index(b"\x00", cpos)
        names.append(ch[cpos:e].decode())
        (ptype,) = struct.unpack_from("<i", ch, e + 1)
        assert ptype == 2  # FLOAT
        cpos = e + 1 + 16
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    assert attrs["compression"][1] == b"\x00"  # NO_COMPRESSION

    offsets = struct.unpack_from("<%dQ" % H, raw, pos)
    planes = {n: np.empty((H, W), np.float32) for n in names}
    for off in offsets:
        y, size = struct.unpack_from("<ii", raw, off)
        assert size == 4 * W * len(names)
        p = off + 8
        for n in names:
            planes[n][y] = np.frombuffer(raw, np.float32, W, p)
            p += 4 * W
    return planes


def test_exr_named_channels(tmp_path):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(5, 9)).astype(np.float32)
    hit = (z > 0).astype(np.float32)
    path = str(tmp_path / "z.exr")
    save_exr(path, {"Z": z, "A": hit})
    planes = _read_exr(path)
    assert sorted(planes) == ["A", "Z"]  # bytewise-sorted channel order
    np.testing.assert_array_equal(planes["Z"], z)
    np.testing.assert_array_equal(planes["A"], hit)


def test_png_and_golden_roundtrip(tmp_path):
    rgb = np.linspace(0, 1, 4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    p = str(tmp_path / "f.png")
    save_png(p, rgb)
    assert os.path.getsize(p) > 0
    from PIL import Image
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (6, 4)
        np.testing.assert_array_equal(np.asarray(im), tonemap_u8(rgb))
    g = str(tmp_path / "g.npz")
    bufs = {"rgb": rgb, "depth": rgb[..., 0]}
    save_golden(g, bufs)
    back = load_golden(g)
    for k in bufs:
        np.testing.assert_array_equal(back[k], bufs[k])


def test_ulp_utilities():
    a = np.float32(1.0)
    b = np.nextafter(a, np.float32(2.0), dtype=np.float32)
    assert ulp_diff_f32(np.asarray([a]), np.asarray([b]))[0] == 1
    assert max_ulp(np.asarray([a, a]), np.asarray([b, a])) == 1
    assert max_ulp(np.asarray([a]), np.asarray([a])) == 0
