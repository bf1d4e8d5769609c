"""Generate the `classroom` benchmark fixture: a 1920x1080, >=500k-triangle,
multi-textured, many-light scene in the spirit of the reference gallery's
classroom render (gallery/classroom.png — the BASELINE.md north-star scene
class): rows of desks and chairs (shared geometry -> exercises the two-level
instanced accel), a displaced relief wall, image-textured posters, a checker
floor, glass + metal props, and 8 area lights (6 ceiling panels + 2 window
strips).

    python tools/make_classroom_scene.py out_dir [--desks N] [--subdiv N]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from akari_render.scenegraph.write import SceneBuilder  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_test_scene import checker_diffuse, glass, principled, quad, uv_sphere  # noqa: E402


# ---- mesh helpers -------------------------------------------------------------
def grid_mesh(nx, ny, corner, ux, uy, displace=None):
    """Regular grid on the parallelogram corner + s*ux + t*uy, optionally
    displaced along the normal. Returns (V [*,3], I [*,3], UV per corner)."""
    s = np.linspace(0, 1, nx + 1)
    t = np.linspace(0, 1, ny + 1)
    S, T = np.meshgrid(s, t, indexing="ij")
    P = (
        np.asarray(corner)[None, None]
        + S[..., None] * np.asarray(ux)[None, None]
        + T[..., None] * np.asarray(uy)[None, None]
    )
    if displace is not None:
        n = np.cross(ux, uy)
        n = n / np.linalg.norm(n)
        P = P + displace(S, T)[..., None] * n[None, None]
    V = P.reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = a + (ny + 1)
            idx.append([a, b, b + 1])
            idx.append([a, b + 1, a + 1])
    I = np.asarray(idx, np.uint32)
    uv_grid = np.stack([S, T], -1).reshape(-1, 2).astype(np.float32)
    UV = uv_grid[I.reshape(-1)]
    return V, I, UV


def subdiv_box(n, size, center=(0, 0, 0)):
    """Axis-aligned box with each face an n x n grid (12*n^2 triangles)."""
    hx, hy, hz = np.asarray(size) / 2.0
    c = np.asarray(center, np.float64)
    faces = [
        ((-hx, -hy, hz), (2 * hx, 0, 0), (0, 2 * hy, 0)),  # +z
        ((-hx, hy, -hz), (2 * hx, 0, 0), (0, -2 * hy, 0)),  # -z
        ((-hx, -hy, -hz), (0, 2 * hy, 0), (0, 0, 2 * hz)),  # -x
        ((hx, -hy, -hz), (0, 0, 2 * hz), (0, 2 * hy, 0)),  # +x
        ((-hx, -hy, -hz), (0, 0, 2 * hz), (2 * hx, 0, 0)),  # -y
        ((-hx, hy, -hz), (2 * hx, 0, 0), (0, 0, 2 * hz)),  # +y
    ]
    Vs, Is, UVs = [], [], []
    base = 0
    for corner, ux, uy in faces:
        V, I, UV = grid_mesh(n, n, np.asarray(corner) + c, ux, uy)
        Vs.append(V)
        Is.append(I + base)
        UVs.append(UV)
        base += len(V)
    return np.concatenate(Vs), np.concatenate(Is).astype(np.uint32), np.concatenate(UVs)


def merge(parts):
    """parts: list of (V, I, UV) -> single (V, I, UV)."""
    Vs, Is, UVs = [], [], []
    base = 0
    for V, I, UV in parts:
        Vs.append(V)
        Is.append(I + base)
        UVs.append(UV)
        base += len(V)
    return np.concatenate(Vs), np.concatenate(Is).astype(np.uint32), np.concatenate(UVs)


def desk_mesh(n):
    """Desk: subdivided top slab + 4 legs. ~12*n^2 + 4*12*(n//3)^2 tris."""
    parts = [subdiv_box(n, (1.2, 0.04, 0.7), (0, 0.75, 0))]
    nl = max(2, n // 3)
    for sx in (-0.52, 0.52):
        for sz in (-0.28, 0.28):
            parts.append(subdiv_box(nl, (0.06, 0.73, 0.06), (sx, 0.365, sz)))
    return merge(parts)


def chair_mesh(n):
    """Chair: seat + back + 4 legs."""
    parts = [
        subdiv_box(n, (0.45, 0.04, 0.45), (0, 0.45, 0)),
        subdiv_box(n, (0.45, 0.5, 0.04), (0, 0.72, 0.22)),
    ]
    nl = max(2, n // 3)
    for sx in (-0.19, 0.19):
        for sz in (-0.19, 0.19):
            parts.append(subdiv_box(nl, (0.045, 0.44, 0.045), (sx, 0.22, sz)))
    return merge(parts)


def _png_texture(b: SceneBuilder, name: str, rgb: np.ndarray):
    from akari_render.core.image_io import encode_png

    png = encode_png((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    view = b.add_array(f"tex.{name}", np.frombuffer(png, np.uint8))
    return {
        "data": view,
        "extension": "repeat",
        "interpolation": "linear",
        "colorspace": "srgb",
        "format": "png",
        "width": rgb.shape[1],
        "height": rgb.shape[0],
        "channels": 4,
    }


def textured(b: SceneBuilder, name: str, rgb: np.ndarray, roughness=0.7):
    nodes = {"tex": {"type": "image", "image": _png_texture(b, name, rgb)}}
    return principled(roughness=roughness, base_color_node=(nodes, {"id": "tex"}))


def build(out_dir: str, n_desk_rows=5, n_desk_cols=6, subdiv=20):
    b = SceneBuilder()
    rng = np.random.default_rng(42)
    W, H, D = 12.0, 3.5, 9.0  # room extents (x, y=up, z)

    # ---- room shell ----
    quad(b, "floor", (-W / 2, 0, -D / 2), (-W / 2, 0, D / 2), (W / 2, 0, D / 2), (W / 2, 0, -D / 2))
    quad(b, "ceiling", (-W / 2, H, -D / 2), (W / 2, H, -D / 2), (W / 2, H, D / 2), (-W / 2, H, D / 2))
    quad(b, "wall_left", (-W / 2, 0, D / 2), (-W / 2, 0, -D / 2), (-W / 2, H, -D / 2), (-W / 2, H, D / 2))
    quad(b, "wall_right", (W / 2, 0, -D / 2), (W / 2, 0, D / 2), (W / 2, H, D / 2), (W / 2, H, -D / 2))
    quad(b, "wall_front", (-W / 2, 0, -D / 2), (W / 2, 0, -D / 2), (W / 2, H, -D / 2), (-W / 2, H, -D / 2))

    # back wall: displaced relief grid (breaks up the cluster accel's AABBs)
    def relief(S, T):
        return 0.06 * np.sin(S * 40) * np.cos(T * 28) + 0.03 * np.sin(S * 97 + 3 * T)

    V, I, UV = grid_mesh(192, 96, (-W / 2, 0, D / 2), (W, 0, 0), (0, H, 0), displace=relief)
    b.add_mesh("wall_back", V, I, uvs=UV)

    # ---- furniture (instanced: shared desk/chair geometry) ----
    V, I, UV = desk_mesh(subdiv)
    b.add_mesh("desk", V, I, uvs=UV)
    V, I, UV = chair_mesh(subdiv)
    b.add_mesh("chair", V, I, uvs=UV)
    desk_tris = 0

    # ---- props ----
    V, I = uv_sphere(48, 96, radius=0.22, center=(0, 0.97, 0))
    b.add_mesh("globe", V, I)
    V, I = uv_sphere(48, 96, radius=0.18, center=(0, 0.93, 0))
    b.add_mesh("apple", V, I)
    # posters
    for k in range(4):
        quad(
            b, f"poster{k}",
            (-W / 2 + 0.01, 1.2, -2.8 + k * 1.9),
            (-W / 2 + 0.01, 1.2, -1.4 + k * 1.9),
            (-W / 2 + 0.01, 2.6, -1.4 + k * 1.9),
            (-W / 2 + 0.01, 2.6, -2.8 + k * 1.9),
        )
    # light panels
    for k in range(6):
        x = -W / 3 + (k % 3) * W / 3
        z = -D / 4 + (k // 3) * D / 2
        quad(
            b, f"panel{k}",
            (x - 0.8, H - 0.02, z - 0.4), (x + 0.8, H - 0.02, z - 0.4),
            (x + 0.8, H - 0.02, z + 0.4), (x - 0.8, H - 0.02, z + 0.4),
        )
    # window strips (bright emitters on the right wall)
    for k in range(2):
        z0 = -2.5 + k * 3.5
        quad(
            b, f"window{k}",
            (W / 2 - 0.01, 1.0, z0), (W / 2 - 0.01, 1.0, z0 + 2.4),
            (W / 2 - 0.01, 2.8, z0 + 2.4), (W / 2 - 0.01, 2.8, z0),
        )

    # ---- materials ----
    xx, yy = np.meshgrid(np.linspace(0, 1, 128), np.linspace(0, 1, 128))
    wallpaper = np.stack(
        [0.75 + 0.1 * np.sin(xx * 50), 0.72 + 0.08 * np.cos(yy * 40), 0.65 + 0 * xx], -1
    )
    woodgrain = np.stack(
        [0.45 + 0.12 * np.sin(yy * 90 + 2 * np.sin(xx * 7)),
         0.3 + 0.08 * np.sin(yy * 90 + 2 * np.sin(xx * 7)),
         0.17 + 0.03 * np.cos(yy * 77)], -1,
    )
    b.add_material("wallpaper", textured(b, "wallpaper", wallpaper, roughness=0.85))
    b.add_material("wood", textured(b, "wood", woodgrain, roughness=0.5))
    b.add_material("whitewall", principled(base_color=(0.78, 0.78, 0.76), roughness=0.9))
    b.add_material("floor_mat", checker_diffuse(scale=24.0))
    b.add_material("plastic_blue", principled(base_color=(0.15, 0.3, 0.65), roughness=0.35))
    b.add_material("metal_leg", principled(base_color=(0.7, 0.7, 0.72), metallic=1.0, roughness=0.3))
    b.add_material("glass_mat", glass())
    b.add_material("apple_red", principled(base_color=(0.7, 0.08, 0.05), roughness=0.4))
    b.add_material("panel_light", principled(emission=(1.0, 0.97, 0.9), estrength=14.0))
    b.add_material("window_light", principled(emission=(0.75, 0.85, 1.0), estrength=28.0))
    for k in range(4):
        art = np.stack(
            [0.5 + 0.5 * np.sin(xx * (8 + 4 * k) + k),
             0.5 + 0.5 * np.cos(yy * (6 + 3 * k)),
             0.5 + 0.5 * np.sin((xx + yy) * (10 - k))], -1,
        )
        b.add_material(f"poster_mat{k}", textured(b, f"poster{k}", art, roughness=0.8))

    # ---- instances ----
    eye = np.eye(4).tolist()
    b.add_instance("floor_i", "floor", eye, ["floor_mat"])
    b.add_instance("ceiling_i", "ceiling", eye, ["whitewall"])
    b.add_instance("wall_left_i", "wall_left", eye, ["wallpaper"])
    b.add_instance("wall_right_i", "wall_right", eye, ["whitewall"])
    b.add_instance("wall_front_i", "wall_front", eye, ["wallpaper"])
    b.add_instance("wall_back_i", "wall_back", eye, ["whitewall"])
    for k in range(4):
        b.add_instance(f"poster{k}_i", f"poster{k}", eye, [f"poster_mat{k}"])
    for k in range(6):
        b.add_instance(f"panel{k}_i", f"panel{k}", eye, ["panel_light"])
    for k in range(2):
        b.add_instance(f"window{k}_i", f"window{k}", eye, ["window_light"])

    n_desks = 0
    for r in range(n_desk_rows):
        for c in range(n_desk_cols):
            x = -W / 2 + 1.6 + c * 1.75 + rng.uniform(-0.03, 0.03)
            z = -D / 2 + 1.8 + r * 1.45 + rng.uniform(-0.03, 0.03)
            ang = rng.uniform(-0.06, 0.06)
            ca, sa = np.cos(ang), np.sin(ang)
            m = np.eye(4)
            m[:3, :3] = [[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]]
            m[:3, 3] = [x, 0, z]
            b.add_instance(f"desk_{r}_{c}", "desk", m.tolist(), ["wood"])
            m2 = m.copy()
            m2[:3, 3] = [x, 0, z + 0.62]
            b.add_instance(f"chair_{r}_{c}", "chair", m2.tolist(), ["plastic_blue"])
            n_desks += 1

    m = np.eye(4)
    m[:3, 3] = [-2.2, 0.78, -3.1]
    b.add_instance("globe_i", "globe", m.tolist(), ["glass_mat"])
    m = np.eye(4)
    m[:3, 3] = [2.0, 0.78 - 0.93 + 0.93, -3.0]
    b.add_instance("apple_i", "apple", m.tolist(), ["apple_red"])

    b.set_camera_perspective(
        trs={
            "translation": [3.9, -3.6, 1.8],  # Blender coords (y fwd, z up)
            "rotation": [np.pi / 2 - 0.10, 0.0, 0.42],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=55.0,
        width=1920,
        height=1080,
    )
    path = b.write(out_dir, compact=True)

    # effective (virtual) triangle count report
    desk_t = len(desk_mesh(subdiv)[1])
    chair_t = len(chair_mesh(subdiv)[1])
    eff = (
        desk_t * n_desks + chair_t * n_desks
        + 192 * 96 * 2 + 2 * 48 * 96 * 2 + (5 + 4 + 8) * 2
    )
    print(f"desk={desk_t} chair={chair_t} x{n_desks} each; effective tris ~{eff}")
    return path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="scenes/classroom")
    ap.add_argument("--desks-rows", type=int, default=5)
    ap.add_argument("--desks-cols", type=int, default=6)
    ap.add_argument("--subdiv", type=int, default=20)
    args = ap.parse_args()
    print(build(args.out, args.desks_rows, args.desks_cols, args.subdiv))
