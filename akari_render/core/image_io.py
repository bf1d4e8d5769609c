"""Image IO: self-contained OpenEXR and PNG codecs (numpy + stdlib only).

The reference writes EXR/PNG through the `exr`/`image` crates
(crates/akari_render/src/util/mod.rs:57-147). Here both formats are
implemented for the subset the renderer needs:
- EXR: single-part scanline float32 RGB, no compression — valid EXR
  readable by any tool;
- PNG: 8-bit, non-interlaced gray / gray+alpha / RGB / RGBA / palette
  images with all five scanline filters (zlib from the stdlib). This covers
  the image textures the scene generators write.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR pixel type FLOAT


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str | Path, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 linear RGB as uncompressed scanline EXR."""
    img = np.asarray(img, dtype=np.float32)
    assert img.ndim == 3 and img.shape[2] == 3, f"expected HxWx3, got {img.shape}"
    h, w, _ = img.shape

    # channel list, alphabetical: B, G, R
    chlist = b""
    for name in (b"B", b"G", b"R"):
        chlist += name + b"\0" + struct.pack("<i", _PIXEL_FLOAT) + struct.pack("<BBBB", 0, 0, 0, 0)
        chlist += struct.pack("<ii", 1, 1)
    chlist += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            _attr("channels", "chlist", chlist),
            _attr("compression", "compression", struct.pack("<B", 0)),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_start = len(preamble)
    data_start = table_start + 8 * h
    line_size = 8 + 3 * 4 * w  # y + size prefix + 3 channels of floats
    offsets = struct.pack("<" + "Q" * h, *[data_start + i * line_size for i in range(h)])

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        bgr = img[:, :, ::-1]  # B, G, R channel order, planar per scanline
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            f.write(np.ascontiguousarray(bgr[y].T).tobytes())


def read_exr(path: str | Path) -> np.ndarray:
    """Read an uncompressed scanline float RGB EXR (as written by write_exr)."""
    return read_exr_bytes(Path(path).read_bytes())


def read_exr_bytes(raw: bytes) -> np.ndarray:
    """Decode an uncompressed scanline float RGB EXR from memory — used for
    EXR image-texture buffers embedded in scene files (ref load.rs:588-614
    routes exr textures through a float decode)."""
    magic, version = struct.unpack_from("<ii", raw, 0)
    assert magic == _MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while raw[pos] != 0:
        name_end = raw.index(b"\0", pos)
        name = raw[pos:name_end].decode()
        pos = name_end + 1
        type_end = raw.index(b"\0", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = raw[pos : pos + size]
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    assert attrs["compression"][0] == 0, "only uncompressed EXR supported"
    # parse channel names
    ch = attrs["channels"]
    cpos, names = 0, []
    while ch[cpos] != 0:
        cend = ch.index(b"\0", cpos)
        names.append(ch[cpos:cend].decode())
        cpos = cend + 1 + 16
    offsets = struct.unpack_from("<" + "Q" * h, raw, pos)
    img = np.zeros((h, w, len(names)), np.float32)
    for y, off in enumerate(offsets):
        _, size = struct.unpack_from("<ii", raw, off)
        line = np.frombuffer(raw, np.float32, count=len(names) * w, offset=off + 8)
        img[y] = line.reshape(len(names), w).T
    order = {n: i for i, n in enumerate(names)}
    if set(names) >= {"R", "G", "B"}:
        img = img[:, :, [order["R"], order["G"], order["B"]]]
    return img


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel (gray, RGB, palette, gray+alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(u8: np.ndarray, filter_type: int = 1) -> bytes:
    """[H, W] or [H, W, C] uint8 (C = 1..4: gray, gray+alpha, RGB, RGBA)
    -> PNG bytes, every scanline with `filter_type` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    u8 = np.asarray(u8, np.uint8)
    if u8.ndim == 2:
        u8 = u8[..., None]
    h, w, c = u8.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = u8.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]  # left neighbour
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]  # up neighbour
    cc = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]  # up-left
    pred = [np.zeros_like(x), a, b, (a + b) // 2, _paeth(a, b, cc)][filter_type]
    rows = ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        _PNG_SIG
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the per-scanline filters. data: [H, W, C] filtered bytes.

    Byte (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1), so every
    pixel on one line x + 2y = s is independent of the others: the loop
    runs over those W + 2H lines, each one vectorized."""
    h, w, c = data.shape
    d = data.astype(np.int32)
    out = np.zeros((h + 1, w + 1, c), np.int32)  # zero row/column padding
    f = ftype.astype(np.int32)
    if (f > 4).any():
        raise ValueError(f"bad PNG filter type {int(f.max())}")
    for s in range(w + 2 * (h - 1)):
        y_lo = max(0, -(-(s - w + 1) // 2))
        ys = np.arange(y_lo, min(h - 1, s // 2) + 1)
        xs = s - 2 * ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        cc = out[ys, xs]
        fy = f[ys][:, None]
        pred = np.where(
            fy == 1, a, np.where(
                fy == 2, b, np.where(
                    fy == 3, (a + b) >> 1, np.where(fy == 4, _paeth(a, b, cc), 0)
                )
            )
        )
        out[ys + 1, xs + 1] = (d[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png_bytes(raw: bytes) -> np.ndarray:
    """Decode a PNG into [H, W, 4] uint8 RGBA (gray replicates into RGB;
    a missing alpha is 255; palette transparency comes from tRNS)."""
    if raw[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, palette, trns, hdr = 8, [], None, None, None
    while pos < len(raw):
        (n,) = struct.unpack_from(">I", raw, pos)
        tag, data = raw[pos + 4 : pos + 8], raw[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color_type not in _PNG_CHANNELS:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, color type {color_type}, "
            f"interlace {interlace} (8-bit non-interlaced only)"
        )
    c = _PNG_CHANNELS[color_type]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    px = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))
    alpha = np.full((h, w, 1), 255, np.uint8)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0]
        rgb = palette[idx]
        if trns is not None:
            table = np.full(len(palette), 255, np.uint8)
            table[: len(trns)] = trns[: len(palette)]
            alpha = table[idx][..., None]
        return np.concatenate([rgb, alpha], -1)
    if color_type in (0, 4):
        rgb = np.repeat(px[..., :1], 3, -1)
        if color_type == 4:
            alpha = px[..., 1:2]
        return np.concatenate([rgb, alpha], -1)
    if color_type == 2:
        return np.concatenate([px, alpha], -1)
    return px


def write_png(path: str | Path, img: np.ndarray, srgb_encode: bool = True) -> None:
    """Write [H, W, 3] linear float RGB to 8-bit PNG (sRGB-encoded by default)."""
    Path(path).write_bytes(encode_png(to_srgb8(img, srgb_encode)))


def to_srgb8(img: np.ndarray, srgb_encode: bool = True) -> np.ndarray:
    """Linear float RGB -> uint8, sRGB-encoded by default."""
    img = np.asarray(img, dtype=np.float32)
    if srgb_encode:
        img = np.where(
            img <= 0.0031308, img * 12.92, 1.055 * np.maximum(img, 1e-10) ** (1 / 2.4) - 0.055
        )
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_image(path: str | Path, img: np.ndarray) -> None:
    """Dispatch by extension like the reference's util::write_image."""
    p = str(path)
    Path(p).parent.mkdir(parents=True, exist_ok=True)
    if p.endswith(".exr"):
        write_exr(p, img)
    elif p.endswith(".png"):
        write_png(p, img)
    else:
        raise ValueError(f"unsupported image extension: {p}")
