"""Generate the `cbox` scene: the Cornell box the renderer is judged on.

Geometry, albedos and emission follow the classic Cornell box as Bitterli's
rendering resources publish it: a 2 x 2 x 2 room (floor y = 0, ceiling
y = 2, back wall z = -1, red wall x = -1, green wall x = +1), a short and a
tall box turned towards each other, and one emissive ceiling quad at
y = 1.98 with radiance (17, 12, 4). Every surface is one Principled
material, so all 8 materials compile to a single shader kind. The camera is
Blender (0, -9, 1), which is (0, 1, 9) in the renderer's y-up frame, looking
down -z with the box's front opening filling the frame.

`pt.json` is upstream's reference PT job: 1024^2, 4096 spp, depth 12,
rr depth 5, pmj02bn sampler, gaussian filter r = 1.5.

    python tools/make_cbox_scene.py [out_dir]      (default scenes/cbox)
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from akari_render.scenegraph.write import SceneBuilder  # noqa: E402
from make_test_scene import principled  # noqa: E402

WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT_RADIANCE = (17.0, 12.0, 4.0)

# horizontal field of view that puts the box's front opening (z = +1, 8
# units in front of the camera) at the frame edges: tan(fov / 2) = 1 / 8
FOV_DEG = float(np.degrees(2.0 * np.arctan(1.0 / 8.0)))

PT_JOB = {
    "method": {
        "type": "pt",
        "spp": 4096,
        "spp_per_pass": 64,
        "max_depth": 12,
        "rr_depth": 5,
    },
    "sampler": {"type": "pmj02bn", "seed": 0},
    "film": {"out": "cbox_pt.exr", "filter": {"type": "gaussian", "radius": 1.5}},
}


def _quad(b, name, corners):
    v = np.asarray(corners, np.float32)
    b.add_mesh(name, v, np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32))


def _box(b, name, center, half, yaw_deg):
    """Axis-aligned box of half extents `half`, turned by `yaw_deg` about +y,
    with all six faces wound so their normals point outwards."""
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    rot = np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    signs = np.asarray(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float
    )
    v = (signs * np.asarray(half)) @ rot.T + np.asarray(center)
    # corner index = 4 * (x > 0) + 2 * (y > 0) + (z > 0)
    faces = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    idx = [[a, bb, cc] for a, bb, cc, _ in faces] + [[a, cc, d] for a, _, cc, d in faces]
    b.add_mesh(name, v.astype(np.float32), np.asarray(idx, np.uint32))


def build(out_dir: str | Path = "scenes/cbox") -> Path:
    b = SceneBuilder()
    # walls wound so geometric normals face the interior
    _quad(b, "floor", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)])
    _quad(b, "ceiling", [(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)])
    _quad(b, "back", [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)])
    _quad(b, "left", [(-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)])
    _quad(b, "right", [(1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)])
    _box(b, "short_box", (0.3286, 0.3, 0.3746), (0.3, 0.3, 0.3), -16.7)
    _box(b, "tall_box", (-0.3354, 0.6, -0.2914), (0.3, 0.6, 0.3), 19.2)
    # light quad facing -y, x in [-0.24, 0.23], z in [-0.22, 0.16]
    _quad(b, "light", [(-0.24, 1.98, -0.22), (0.23, 1.98, -0.22),
                       (0.23, 1.98, 0.16), (-0.24, 1.98, 0.16)])

    for name, albedo in [("floor", WHITE), ("ceiling", WHITE), ("back", WHITE),
                         ("left", RED), ("right", GREEN),
                         ("short_box", WHITE), ("tall_box", WHITE)]:
        b.add_material(name, principled(base_color=albedo, roughness=1.0))
        b.add_instance(name, name, np.eye(4).tolist(), [name])
    b.add_material(
        "light",
        principled(base_color=(0.0, 0.0, 0.0), roughness=1.0,
                   emission=LIGHT_RADIANCE, estrength=1.0),
    )
    b.add_instance("light", "light", np.eye(4).tolist(), ["light"])

    b.set_camera_perspective(
        trs={
            "translation": [0.0, -9.0, 1.0],
            "rotation": [np.pi / 2, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=FOV_DEG,
        width=1024,
        height=1024,
    )
    path = b.write(out_dir, compact=True)
    (Path(out_dir) / "pt.json").write_text(json.dumps(PT_JOB, indent=2) + "\n")
    return path


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else "scenes/cbox"))
