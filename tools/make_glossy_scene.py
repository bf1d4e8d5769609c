"""Glossy MSE fixture: low-roughness floor + metal spheres under one area
light — the stress case for GPT's reconnection shift (most path vertices
fail the default roughness>=0.2 criterion; raise it via
benchmark_mse.py --gpt-min-roughness 0.4 so prefixes replay further).

    python tools/make_glossy_scene.py  # writes scenes/glossy/
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import make_test_scene as M  # noqa: E402

from akari_render.scenegraph.write import SceneBuilder  # noqa: E402


def build(out_dir="scenes/glossy"):
    b = SceneBuilder()
    s = 4.0
    M.quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    M.quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))
    ls = 1.2
    M.quad(b, "lamp", (-ls, 2 * s - 0.01, -ls), (ls, 2 * s - 0.01, -ls),
           (ls, 2 * s - 0.01, ls), (-ls, 2 * s - 0.01, ls))
    V, I = M.uv_sphere(24, 48, radius=0.9)
    b.add_mesh("ball", V, I)
    b.add_material("glossy_floor", M.principled(
        base_color=(0.7, 0.7, 0.72), roughness=0.12))
    b.add_material("glossy_wall", M.principled(
        base_color=(0.6, 0.62, 0.7), roughness=0.3))
    b.add_material("metal_a", M.principled(
        base_color=(0.95, 0.64, 0.34), metallic=1.0, roughness=0.25))
    b.add_material("metal_b", M.principled(
        base_color=(0.6, 0.7, 0.9), metallic=1.0, roughness=0.45))
    b.add_material("light", M.principled(emission=(1.0, 0.9, 0.7), estrength=22.0))
    eye = np.eye(4)
    b.add_instance("floor_i", "floor", eye.tolist(), ["glossy_floor"])
    b.add_instance("back_i", "back", eye.tolist(), ["glossy_wall"])
    b.add_instance("lamp_i", "lamp", eye.tolist(), ["light"])
    for k, (x, z, mat) in enumerate(
        [(-1.6, -0.5, "metal_a"), (1.4, 0.8, "metal_b")]
    ):
        m = np.eye(4)
        m[:3, 3] = [x, 0.92, z]
        b.add_instance(f"ball_{k}", "ball", m.tolist(), [mat])
    b.set_camera_perspective(
        trs={
            "translation": [0.0, -10.0, 3.2],
            "rotation": [np.pi / 2 - 0.12, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=42.0,
        width=256,
        height=256,
    )
    return b.write(Path(out_dir), compact=True)


if __name__ == "__main__":
    print("wrote", build())
