"""Self-contained PNG codec (core/image_io.py): round trips through every
scanline filter and colour type, decode of palette images and of every
PNG texture the in-repo scenes carry, checked against PIL where PIL is
installed, and the errors for what the codec does not decode."""
import io
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from akari_render.core.image_io import encode_png, read_png_bytes, to_srgb8

REPO = Path(__file__).resolve().parent.parent


def _rgba(u8):
    """What read_png_bytes returns for an [H, W, C] uint8 image."""
    h, w, c = u8.shape
    if c in (1, 2):
        rgb = np.repeat(u8[..., :1], 3, -1)
    else:
        rgb = u8[..., :3]
    alpha = u8[..., -1:] if c in (2, 4) else np.full((h, w, 1), 255, np.uint8)
    return np.concatenate([rgb, alpha], -1)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_round_trip(filter_type, channels):
    rng = np.random.default_rng(10 * channels + filter_type)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    png = encode_png(img, filter_type)
    np.testing.assert_array_equal(read_png_bytes(png), _rgba(img))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_decode_matches_pil(filter_type):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(filter_type)
    img = rng.integers(0, 256, (9, 31, 4), dtype=np.uint8)
    png = encode_png(img, filter_type)
    pil = np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))
    np.testing.assert_array_equal(read_png_bytes(png), pil)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_decode_pil_encoded(mode):
    """PIL's encoder picks its own filters per scanline (adaptive)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    base = Image.fromarray(rng.integers(0, 256, (21, 26, 3), dtype=np.uint8))
    if mode == "P":
        im = base.convert("P", palette=Image.Palette.ADAPTIVE, colors=200)
        kw = {"transparency": 3}
    else:
        im = base.convert(mode)
        kw = {}
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=True, **kw)
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
    np.testing.assert_array_equal(read_png_bytes(buf.getvalue()), pil)


def _scene_textures():
    out = []
    for scene in sorted((REPO / "scenes").glob("*/scene.json")):
        doc = json.loads(scene.read_text())
        for mname, mat in doc["materials"].items():
            for node in mat["shader"]["nodes"].values():
                if node.get("type") == "image" and node["image"].get("format") == "png":
                    out.append((scene.parent.name, mname))
    return out


@pytest.mark.parametrize("scene,material", _scene_textures())
def test_in_repo_textures_match_pil(scene, material):
    Image = pytest.importorskip("PIL.Image")
    from akari_render.scenegraph.model import load_scene_json

    sg = load_scene_json(str(REPO / "scenes" / scene / "scene.json"))
    for node in sg.materials[material]["shader"]["nodes"].values():
        if node.get("type") == "image":
            raw = sg.buffer_view(node["image"]["data"], np.uint8).tobytes()
            pil = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
            ours = read_png_bytes(raw)
            assert ours.shape == (node["image"]["height"], node["image"]["width"], 4)
            np.testing.assert_array_equal(ours, pil)


def _png(ihdr: bytes, payload: bytes) -> bytes:
    import struct

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(payload)) + chunk(b"IEND", b""))


@pytest.mark.parametrize(
    "depth,color_type,interlace",
    [(16, 2, 0), (4, 3, 0), (8, 2, 1)],
    ids=["16-bit", "4-bit-palette", "interlaced"],
)
def test_unsupported_png_raises(depth, color_type, interlace):
    import struct

    png = _png(struct.pack(">IIBBBBB", 2, 2, depth, color_type, 0, 0, interlace),
               b"\0" * 64)
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png_bytes(png)


def test_jpeg_texture_without_pil_names_the_format(monkeypatch):
    import sys

    from akari_render.scene import _decode_with_pil

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="jpeg image textures need PIL"):
        _decode_with_pil(b"\xff\xd8", "jpeg")


def test_write_png_is_srgb_encoded(tmp_path):
    from akari_render.core.image_io import write_png

    img = np.zeros((2, 3, 3), np.float32)
    img[..., 0] = 0.5  # linear 0.5 -> sRGB 188
    img[..., 1] = 2.0  # clipped
    p = tmp_path / "x.png"
    write_png(p, img)
    back = read_png_bytes(p.read_bytes())
    np.testing.assert_array_equal(back[..., :3], to_srgb8(img))
    assert back[0, 0, 0] == 188 and back[0, 0, 1] == 255 and back[0, 0, 2] == 0
