"""Generate the `matbox` test fixture: a Cornell-style box exercising the
full material system — principled diffuse walls, a glass sphere, a metallic
principled sphere, a checkerboard floor, an image-textured back wall, and an
area light. Gives the renderer a multi-kind, textured regression scene
(the reference's cbox has a single shader kind).

    python tools/make_test_scene.py out_dir
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from akari_render.scenegraph.write import SceneBuilder  # noqa: E402


def quad(builder, name, a, b, c, d):
    v = np.asarray([a, b, c, d], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    # per-corner uvs (two triangles): unit square mapping
    uv = np.asarray(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32
    )
    builder.add_mesh(name, v, idx, uvs=uv)
    return name


def uv_sphere(n_theta=16, n_phi=32, radius=1.0, center=(0, 0, 0)):
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], -1
    ) * radius + np.asarray(center)
    V = pts.reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            p00 = i * (n_phi + 1) + j
            p01 = p00 + 1
            p10 = p00 + (n_phi + 1)
            p11 = p10 + 1
            idx.append([p00, p10, p11])
            idx.append([p00, p11, p01])
    return V, np.asarray(idx, np.uint32)


def _const(nodes, counter, d):
    name = f"$c{counter[0]}"
    counter[0] += 1
    nodes[name] = d
    return {"id": name}


def principled(base_color=(0.8, 0.8, 0.8), roughness=0.5, metallic=0.0,
               transmission=0.0, ior=1.45, emission=(0, 0, 0), estrength=0.0,
               base_color_node=None):
    nodes = {}
    c = [0]

    def f(v):
        return _const(nodes, c, {"type": "float", "value": float(v)})

    def f3(v):
        return _const(nodes, c, {"type": "float3", "value": [float(x) for x in v]})

    def spec(v):
        rgb = _const(nodes, c, {"type": "rgb", "value": [float(x) for x in v], "colorspace": "srgb"})
        return _const(nodes, c, {"type": "spectral_uplift", "rgb": rgb})

    if base_color_node is not None:
        extra_nodes, bc_ref = base_color_node
        nodes.update(extra_nodes)
        bc = _const(nodes, c, {"type": "spectral_uplift", "rgb": bc_ref})
    else:
        bc = spec(base_color)
    nodes["bsdf"] = {
        "type": "principled",
        "preference": "mix",
        "base_color": bc,
        "metallic": f(metallic),
        "roughness": f(roughness),
        "ior": f(ior),
        "alpha": f(1.0),
        "normal": f3((0, 0, 0)),
        "subsurface_weight": f(0.0),
        "subsurface_radius": f3((1, 0.2, 0.1)),
        "subsurface_scale": f(0.05),
        "subsurface_anisotropy": f(0.0),
        "specular_ior_level": f(0.5),
        "specular_tint": spec((1, 1, 1)),
        "anisotropic": f(0.0),
        "anisotropic_rotation": f(0.0),
        "tangent": f3((0, 0, 0)),
        "transmission_weight": f(transmission),
        "sheen_weight": f(0.0),
        "sheen_tint": spec((1, 1, 1)),
        "coat_weight": f(0.0),
        "coat_roughness": f(0.03),
        "coat_ior": f(1.5),
        "coat_tint": spec((1, 1, 1)),
        "coat_normal": f3((0, 0, 0)),
        "emission_color": spec(emission if max(emission) > 0 else (1, 1, 1)),
        "emission_strength": f(estrength),
    }
    nodes["out"] = {"type": "output", "node": {"id": "bsdf"}}
    return {"nodes": nodes, "output": {"id": "out"}, "kind": "surface"}


def glass(color=(1, 1, 1), ior=1.5, roughness=0.05, dispersion=0.0):
    """dispersion: Cauchy B coefficient in um^2 (0 = none; BK7 ~ 0.0042).
    Only the spectral transport uses it (svm/eval.py::_glass)."""
    nodes = {}
    c = [0]
    rgb = _const(nodes, c, {"type": "rgb", "value": list(color), "colorspace": "srgb"})
    up = _const(nodes, c, {"type": "spectral_uplift", "rgb": rgb})
    nodes["bsdf"] = {
        "type": "glass",
        "color": up,
        "ior": _const(nodes, c, {"type": "float", "value": ior}),
        "roughness": _const(nodes, c, {"type": "float", "value": roughness}),
    }
    if dispersion:
        nodes["bsdf"]["dispersion"] = float(dispersion)
    nodes["out"] = {"type": "output", "node": {"id": "bsdf"}}
    return {"nodes": nodes, "output": {"id": "out"}, "kind": "surface"}


def checker_diffuse(scale=6.0):
    nodes = {}
    c = [0]
    c1 = _const(nodes, c, {"type": "rgb", "value": [0.9, 0.9, 0.9], "colorspace": "srgb"})
    c1u = _const(nodes, c, {"type": "spectral_uplift", "rgb": c1})
    c2 = _const(nodes, c, {"type": "rgb", "value": [0.15, 0.15, 0.35], "colorspace": "srgb"})
    c2u = _const(nodes, c, {"type": "spectral_uplift", "rgb": c2})
    nodes["check"] = {
        "type": "checkerboard",
        "vector": None,
        "scale": _const(nodes, c, {"type": "float", "value": scale}),
        "color1": c1u,
        "color2": c2u,
    }
    nodes["bsdf"] = {"type": "diffuse", "color": {"id": "check"}}
    nodes["out"] = {"type": "output", "node": {"id": "bsdf"}}
    return {"nodes": nodes, "output": {"id": "out"}, "kind": "surface"}


def textured_principled(builder):
    """Back wall with a generated PNG image texture."""
    from akari_render.core.image_io import encode_png

    # generate a simple gradient+stripes texture
    w = h = 64
    xx, yy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    rgb = np.stack([xx, yy, ((xx * 6).astype(int) % 2) * 0.8 + 0.2], -1)
    data = np.frombuffer(encode_png((rgb * 255).astype(np.uint8)), np.uint8)
    view = builder.add_array("tex.stripes", data)
    nodes = {
        "tex": {
            "type": "image",
            "image": {
                "data": view,
                "extension": "repeat",
                "interpolation": "linear",
                "colorspace": "srgb",
                "format": "png",
                "width": w,
                "height": h,
                "channels": 4,
            },
        }
    }
    return principled(roughness=0.8, base_color_node=(nodes, {"id": "tex"}))


def build(out_dir: str):
    b = SceneBuilder()
    s = 2.0  # half size
    # box quads (y-up), wound so geometric normals face the interior
    # (emission and the light-leak check are one-sided — ng matters)
    quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))  # +y
    quad(b, "ceiling", (-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s))  # -y
    quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))  # +z
    quad(b, "left", (-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s))  # +x
    quad(b, "right", (s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s))  # -x
    ls = 0.6
    ly = 2 * s - 0.01
    quad(b, "lamp", (-ls, ly, -ls), (ls, ly, -ls), (ls, ly, ls), (-ls, ly, ls))  # -y
    V, I = uv_sphere(24, 48, radius=0.7, center=(-0.85, 0.7, -0.4))
    b.add_mesh("glass_ball", V, I)
    V2, I2 = uv_sphere(24, 48, radius=0.7, center=(0.9, 0.7, 0.5))
    b.add_mesh("metal_ball", V2, I2)

    b.add_material("white", principled(base_color=(0.73, 0.73, 0.73), roughness=0.9))
    b.add_material("red", principled(base_color=(0.65, 0.06, 0.06), roughness=0.9))
    b.add_material("green", principled(base_color=(0.1, 0.55, 0.1), roughness=0.9))
    b.add_material("checker", checker_diffuse())
    b.add_material("tex_wall", textured_principled(b))
    b.add_material("glass", glass())
    b.add_material("metal", principled(base_color=(0.95, 0.64, 0.34), metallic=1.0, roughness=0.25))
    b.add_material("light", principled(emission=(1.0, 0.85, 0.6), estrength=18.0))

    eye = np.eye(4).tolist()
    b.add_instance("floor_i", "floor", eye, ["checker"])
    b.add_instance("ceiling_i", "ceiling", eye, ["white"])
    b.add_instance("back_i", "back", eye, ["tex_wall"])
    b.add_instance("left_i", "left", eye, ["red"])
    b.add_instance("right_i", "right", eye, ["green"])
    b.add_instance("lamp_i", "lamp", eye, ["light"])
    b.add_instance("glass_i", "glass_ball", eye, ["glass"])
    b.add_instance("metal_i", "metal_ball", eye, ["metal"])

    b.set_camera_perspective(
        trs={
            "translation": [0.0, -7.5, 2.0],
            "rotation": [np.pi / 2, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=32.0,
        width=512,
        height=512,
    )
    return b.write(out_dir, compact=True)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "scenes/matbox"
    print(build(out))
