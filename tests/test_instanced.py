"""Two-level instanced accel (accel/instanced.py; ref mesh.rs:288-333
BLAS/TLAS): N instances of an M-tri mesh must cost O(M)+O(N) memory and
render identically to the flattened path."""
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from akari_render.scene import load_scene


def _build_instanced_scene(tmp_path, n_inst=5):
    import make_test_scene as M

    from akari_render.scenegraph.write import SceneBuilder

    b = SceneBuilder()
    s = 4.0
    M.quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    ls = 1.0
    M.quad(b, "lamp", (-ls, 2 * s, -ls), (ls, 2 * s, -ls), (ls, 2 * s, ls), (-ls, 2 * s, ls))
    V, I = M.uv_sphere(12, 24, radius=0.5)
    b.add_mesh("ball", V, I)
    b.add_material("white", M.principled(base_color=(0.7, 0.7, 0.7), roughness=0.8))
    b.add_material("shiny", M.principled(base_color=(0.8, 0.4, 0.3), roughness=0.3))
    b.add_material("light", M.principled(emission=(1, 1, 1), estrength=10.0))
    eye = np.eye(4).tolist()
    b.add_instance("floor_i", "floor", eye, ["white"])
    b.add_instance("lamp_i", "lamp", eye, ["light"])
    rng = np.random.default_rng(3)
    for k in range(n_inst):
        m = np.eye(4)
        m[:3, 3] = [(k - n_inst / 2) * 1.3, 0.6, rng.uniform(-1, 1)]
        sc = 0.7 + 0.1 * k
        m[:3, :3] *= sc
        b.add_instance(f"ball_{k}", "ball", m.tolist(), ["shiny" if k % 2 else "white"])
    b.set_camera_perspective(
        trs={
            "translation": [0.0, -9.0, 1.5],
            "rotation": [np.pi / 2, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=40.0,
        width=32,
        height=32,
    )
    return b.write(tmp_path / "inst", compact=True)


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    path = _build_instanced_scene(tmp_path_factory.mktemp("inst"))
    os.environ["AKR_INSTANCE_MIN_TRIS"] = "64"
    try:
        os.environ["AKR_INSTANCING"] = "1"
        s_inst = load_scene(path)
        os.environ["AKR_INSTANCING"] = "0"
        s_flat = load_scene(path)
    finally:
        os.environ.pop("AKR_INSTANCING", None)
        os.environ.pop("AKR_INSTANCE_MIN_TRIS", None)
    return s_inst, s_flat


def _rays(n=256):
    rng = np.random.default_rng(11)
    o = np.asarray([0.0, 5.0, 8.0], np.float32) + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, (n, 3)).astype(np.float32) * np.asarray([1, 0.3, 1], np.float32)
    d = tgt - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d), jnp.zeros((n,)), jnp.full((n,), 1e8)


class TestInstanced:
    def test_memory_is_per_mesh(self, scene_pair):
        s_inst, s_flat = scene_pair
        ia = s_inst.arrays.instanced
        assert ia is not None
        n_ball_tris = s_flat.num_tris - s_inst.num_tris  # flattened ball total
        assert ia.tri_base.shape[0] == 5  # 5 instances
        # local storage is ONE mesh copy, not 5
        assert ia.v0.shape[0] * 5 == n_ball_tris

    def test_hits_match_flattened(self, scene_pair):
        s_inst, s_flat = scene_pair
        o, d, tmin, tmax = _rays()
        h_i = s_inst.intersect(o, d, tmin, tmax)
        h_f = s_flat.intersect(o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(h_i.valid), np.asarray(h_f.valid))
        np.testing.assert_allclose(np.asarray(h_i.t), np.asarray(h_f.t), rtol=1e-4, atol=1e-5)

    def test_occlusion_matches(self, scene_pair):
        s_inst, s_flat = scene_pair
        o, d, tmin, tmax = _rays()
        occ_i = s_inst.occlude(o, d, tmin, jnp.full_like(tmax, 6.0))
        occ_f = s_flat.occlude(o, d, tmin, jnp.full_like(tmax, 6.0))
        np.testing.assert_array_equal(np.asarray(occ_i), np.asarray(occ_f))

    def test_interaction_matches(self, scene_pair):
        s_inst, s_flat = scene_pair
        o, d, tmin, tmax = _rays()
        h_i = s_inst.intersect(o, d, tmin, tmax)
        h_f = s_flat.intersect(o, d, tmin, tmax)
        si_i = s_inst.surface_interaction(jnp.maximum(h_i.tri_id, 0), h_i.bary)
        si_f = s_flat.surface_interaction(jnp.maximum(h_f.tri_id, 0), h_f.bary)
        v = np.asarray(h_i.valid)
        for key in ("p", "ng", "ns", "uv", "area"):
            np.testing.assert_allclose(
                np.asarray(si_i[key])[v], np.asarray(si_f[key])[v],
                rtol=2e-3, atol=2e-4, err_msg=key,
            )
        np.testing.assert_array_equal(
            np.asarray(si_i["mat"])[v], np.asarray(si_f["mat"])[v]
        )
        np.testing.assert_array_equal(
            np.asarray(si_i["kind"])[v], np.asarray(si_f["kind"])[v]
        )

    def test_render_matches_flattened(self, scene_pair):
        from akari_render.config import PTConfig
        from akari_render.integrators.pt import render_pt

        s_inst, s_flat = scene_pair
        cfg = PTConfig(spp=8, max_depth=3, spp_per_pass=8)
        img_i, _ = render_pt(s_inst, cfg)
        img_f, _ = render_pt(s_flat, cfg)
        assert np.isfinite(img_i).all()
        # identical sample streams + identical geometry -> near-identical
        np.testing.assert_allclose(img_i, img_f, rtol=1e-3, atol=2e-3)

    def test_exclusion_ids_respected(self, scene_pair):
        s_inst, _ = scene_pair
        o, d, tmin, tmax = _rays()
        h1 = s_inst.intersect(o, d, tmin, tmax)
        ex = jnp.where(h1.valid, h1.tri_id, -1)
        h2 = s_inst.intersect(o, d, tmin, tmax, exclude0=ex)
        hit_same = np.asarray(h2.valid & (h2.tri_id == h1.tri_id) & h1.valid)
        assert not hit_same.any()
