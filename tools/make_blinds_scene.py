"""Blinds MSE fixture: the reconnection-SHOULD-win scene (VERDICT r3 item 7).

All receivers are DIFFUSE (every vertex passes the min_roughness 0.2 gate)
and the illumination crosses a rank of thin slats in front of a bright
panel — high-frequency visibility. Primary-sample-space replay re-runs the
offset pixel's sampling decisions from scratch: a cosine direction replayed
from the neighbouring primary hit crosses a slat boundary and the secondary
vertex lands on the opposite side of a hard shadow edge, decorrelating the
pair. The reconnection shift pins the offset path to the base path's second
vertex, so the pair stays correlated (Kettunen et al. 2015's motivation;
ref gpt.rs:318-331 gates reconnection by roughness because it assumes it
wins whenever endpoints are diffuse).

    python tools/make_blinds_scene.py  # writes scenes/blinds/
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import make_test_scene as M  # noqa: E402

from akari_render.scenegraph.write import SceneBuilder  # noqa: E402


def build(out_dir="scenes/blinds"):
    b = SceneBuilder()
    s = 3.0
    # room: floor + back wall + far side wall (diffuse receivers)
    M.quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    M.quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))
    M.quad(b, "left", (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s), (-s, 0, s))
    # small bright panel high on the right wall: a compact source so slat
    # shadows stay hard (penumbra ~ source_size * d(slat, wall)/d(source,
    # slat) ~ 0.07 << slat pitch)
    M.quad(b, "panel", (s, 3.2, -0.5), (s, 3.2, 0.5), (s, 4.2, 0.5), (s, 4.2, -0.5))
    # blinds: horizontal slats close to the LEFT wall; light from the panel
    # stripes the left wall + floor through the gaps
    n_slats = 10
    pitch = 2 * s / n_slats
    xs = -s + 0.5
    for k in range(n_slats):
        y0 = k * pitch
        y1 = y0 + 0.55 * pitch
        M.quad(
            b, f"slat{k}",
            (xs, y0, -s), (xs, y1, -s), (xs, y1, s), (xs, y0, s),
        )

    b.add_material("white", M.principled(base_color=(0.72, 0.72, 0.72), roughness=1.0))
    b.add_material("grey", M.principled(base_color=(0.5, 0.52, 0.55), roughness=1.0))
    b.add_material("slat", M.principled(base_color=(0.25, 0.22, 0.2), roughness=1.0))
    b.add_material("light", M.principled(emission=(1.0, 0.95, 0.85), estrength=15.0))

    eye = np.eye(4)
    b.add_instance("floor_i", "floor", eye.tolist(), ["white"])
    b.add_instance("back_i", "back", eye.tolist(), ["white"])
    b.add_instance("left_i", "left", eye.tolist(), ["grey"])
    b.add_instance("panel_i", "panel", eye.tolist(), ["light"])
    for k in range(n_slats):
        b.add_instance(f"slat{k}_i", f"slat{k}", eye.tolist(), ["slat"])

    b.set_camera_perspective(
        trs={
            "translation": [1.2, -8.5, 3.0],
            "rotation": [np.pi / 2 - 0.12, 0.0, 0.35],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=46.0,
        width=256,
        height=256,
    )
    out = Path(out_dir)
    b.write(out)
    print(f"wrote {out}/scene.json")


if __name__ == "__main__":
    build()
