"""The Cornell box generator (tools/make_cbox_scene.py): the structure the
scene tests rely on, upstream's PT job in pt.json, and the committed
scenes/cbox being exactly what the generator writes."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import make_cbox_scene  # noqa: E402


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("cbox")
    make_cbox_scene.build(out)
    return out


@pytest.fixture(scope="module")
def scene(generated):
    from akari_render.scene import load_scene

    return load_scene(str(generated / "scene.json"), width=8, height=8)


def test_geometry_counts(scene):
    # 5 walls + 1 light quad (2 triangles each) + 2 boxes (12 each)
    assert scene.num_tris == 36
    assert len(scene.material_names) == 8
    assert len(scene.kinds) == 1
    assert scene.arrays.lights.num_lights == 1


def test_room_bounds(scene):
    v0 = np.asarray(scene.arrays.v0)
    v1 = v0 + np.asarray(scene.arrays.e1)
    v2 = v0 + np.asarray(scene.arrays.e2)
    pts = np.concatenate([v0, v1, v2])
    np.testing.assert_allclose(pts.min(0), [-1, 0, -1], atol=1e-6)
    np.testing.assert_allclose(pts.max(0), [1, 2, 1], atol=1e-6)


def test_light_quad_faces_down(scene):
    lit = np.nonzero(np.asarray(scene.arrays.lights.tri_light_id) >= 0)[0]
    assert len(lit) == 2
    np.testing.assert_allclose(np.asarray(scene.arrays.v0)[lit][:, 1], 1.98, atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.arrays.ng)[lit], [[0, -1, 0]] * 2,
                               atol=1e-6)


def test_walls_face_inwards_and_boxes_outwards(scene):
    ng = np.asarray(scene.arrays.ng)
    v0 = np.asarray(scene.arrays.v0)
    c = v0 + (np.asarray(scene.arrays.e1) + np.asarray(scene.arrays.e2)) / 3.0
    mat = np.asarray(scene.arrays.tri_mat)
    for m, name in enumerate(scene.material_names):
        sel = mat == m
        if name.endswith("_box"):
            center = c[sel].mean(0)
            outward = ((c[sel] - center) * ng[sel]).sum(-1)
            assert (outward > 0).all(), name
        elif name != "light":
            inward = ((np.array([0.0, 1.0, 0.0]) - c[sel]) * ng[sel]).sum(-1)
            assert (inward > 0).all(), name


def test_camera_and_job(generated, scene):
    np.testing.assert_allclose(
        np.asarray(scene.camera.c2w)[:3, 3], [0.0, 1.0, 9.0], atol=1e-5
    )
    job = json.loads((generated / "pt.json").read_text())
    assert job["method"] == {"type": "pt", "spp": 4096, "spp_per_pass": 64,
                             "max_depth": 12, "rr_depth": 5}
    assert job["sampler"]["type"] == "pmj02bn"
    assert job["film"]["filter"] == {"type": "gaussian", "radius": 1.5}
    cam = json.loads((generated / "scene.json").read_text())["camera"]["data"]
    assert (cam["sensor_width"], cam["sensor_height"]) == (1024, 1024)


@pytest.mark.parametrize("name", ["Scene.bin", "pt.json"])
def test_committed_scene_is_generated(generated, name):
    assert (generated / name).read_bytes() == (REPO / "scenes" / "cbox" / name).read_bytes()


def test_committed_scene_json_is_generated(generated):
    a = json.loads((generated / "scene.json").read_text())
    b = json.loads((REPO / "scenes" / "cbox" / "scene.json").read_text())
    # buffer paths name the output directory; everything else is identical
    for doc in (a, b):
        for buf in doc["buffers"].values():
            buf["path"] = Path(buf["path"]).name
    assert a == b
