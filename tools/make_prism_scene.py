"""Generate the `prism` dispersion fixture (round 5, VERDICT r4 item 9).

A glass wedge between the camera and a narrow vertical white light strip,
inside a dim gray room. Camera rays enter the wedge's flat front face and
refract at its tilted back face; with a Cauchy dispersion coefficient on
the glass, the lateral deviation of the strip image depends on the hero
wavelength — the spectral transport renders red/blue fringes where the RGB
transport (and a zero-dispersion spectral render) stays achromatic. This is
the "one visible proof" that the spectral path does something RGB cannot:
the reference declares the spectral types but leaves every spectral path
todo!() (color.rs:71-73).

Deviation math (flat front, back face tilted A=25deg, n=1.5): camera rays
hit the front face near normal incidence, so the only bend is at the back
face: delta = asin(n sin A) - A ~ 14deg, with d(delta)/dn ~ 0.55 rad. The
default Cauchy B = 0.04 um^2 (exaggerated flint, ~10x BK7 for a clear
demo at 256^2) gives delta-n(450..650nm) ~ 0.10 -> ~3.2deg of angular
spread, about half the strip's width at the wall. The fixture is geometry-
only physics: no tuned constants beyond the exaggerated B.

    python tools/make_prism_scene.py [out_dir] [dispersion]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from akari_render.scenegraph.write import SceneBuilder  # noqa: E402
from make_test_scene import glass, principled, quad  # noqa: E402


def wedge_mesh(half_w=1.2, y0=0.2, y1=2.3, z_front=0.5, tilt_deg=25.0):
    """Right-triangle prism, extruded along y (renderer space is y-up):
    flat front face at z = z_front (normal +z, toward the camera), back
    face tilted by tilt_deg around the y axis."""
    dz = 2 * half_w * np.tan(np.radians(tilt_deg))
    tri = np.array(
        [[-half_w, z_front], [half_w, z_front], [half_w, z_front - dz]],
        np.float32,
    )  # (x, z) cross-section
    v = np.array(
        [[x, y0, z] for x, z in tri] + [[x, y1, z] for x, z in tri],
        np.float32,
    )
    idx = [[0, 1, 2], [3, 5, 4]]  # caps
    for a, b in ((0, 1), (1, 2), (2, 0)):  # side quads
        idx += [[a, b, b + 3], [a, b + 3, a + 3]]
    return v, np.asarray(idx, np.uint32)


def build(out_dir: str, dispersion: float = 0.04):
    b = SceneBuilder()
    s = 2.5
    # dim gray room, y-up, open toward the camera at +z (matbox layout)
    quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    quad(b, "ceiling", (-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s))
    quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))
    quad(b, "left", (-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s))
    quad(b, "right", (s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s))
    # narrow vertical light strip on the back wall (faces +z, to the camera)
    lw, zl = 0.12, -s + 0.01
    yb, yt = 0.8, 2 * s - 0.8
    quad(b, "strip", (-lw, yb, zl), (lw, yb, zl), (lw, yt, zl), (-lw, yt, zl))
    V, I = wedge_mesh()
    b.add_mesh("wedge", V, I)

    b.add_material("gray", principled(base_color=(0.18, 0.18, 0.18), roughness=0.9))
    b.add_material(
        "wedge_glass", glass(ior=1.5, roughness=0.03, dispersion=dispersion)
    )
    b.add_material("light", principled(emission=(1.0, 1.0, 1.0), estrength=40.0))

    eye = np.eye(4).tolist()
    for name in ("floor", "ceiling", "back", "left", "right"):
        b.add_instance(name + "_i", name, eye, ["gray"])
    b.add_instance("strip_i", "strip", eye, ["light"])
    b.add_instance("wedge_i", "wedge", eye, ["wedge_glass"])

    # Blender TRS (z-up) -> renderer (x, z, -y): camera at (0, 1.25, 5.5)
    # looking down -z through the wedge at the strip
    b.set_camera_perspective(
        trs={
            "translation": [0.0, -5.5, 1.25],
            "rotation": [np.pi / 2, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=34.0,
        width=256,
        height=256,
    )
    return b.write(out_dir, compact=True)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "scenes/prism"
    disp = float(sys.argv[2]) if len(sys.argv) > 2 else 0.04
    print(build(out, disp))
