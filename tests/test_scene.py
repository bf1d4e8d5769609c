"""Scene loading + light sampling + end-to-end render integration tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akari_render.config import PTConfig
from akari_render.scene import load_scene

CBOX_D5_MEAN = [0.180, 0.118, 0.0337]


@pytest.fixture(scope="module")
def cbox(cbox_path):
    return load_scene(cbox_path, width=16, height=16)


class TestLoading:
    def test_cbox_structure(self, cbox):
        assert cbox.num_tris == 36
        assert len(cbox.kinds) == 1  # all 8 principled materials dedupe
        assert cbox.arrays.lights.num_lights == 1
        assert len(cbox.material_names) == 8

    def test_camera(self, cbox):
        c2w = np.asarray(cbox.camera.c2w)
        # Blender camera (0,-9,1) -> Akari Y-up (0,1,9) (load.rs:152-160)
        np.testing.assert_allclose(c2w[:3, 3], [0.0, 1.0, 9.0], atol=1e-5)

    def test_light_is_ceiling_quad(self, cbox):
        la = cbox.arrays.lights
        lit = np.asarray(la.tri_light_id)
        lit_tris = np.nonzero(lit >= 0)[0]
        assert len(lit_tris) == 2  # the light quad
        # light triangles are near the ceiling (y ~ 1.98)
        v0 = np.asarray(cbox.arrays.v0)[lit_tris]
        assert (v0[:, 1] > 1.9).all()

    def test_areas_positive(self, cbox):
        a = np.asarray(cbox.arrays.area)
        assert (a > 0).all()

    def test_prim_pdf_normalized(self, cbox):
        la = cbox.arrays.lights
        assert abs(float(la.tri_prim_pdf.sum()) - 1.0) < 1e-5


class TestSurfaceInteraction:
    def test_interpolation_matches_vertices(self, cbox):
        tri = jnp.array([0, 5, 10], jnp.int32)
        # bary (0,0) -> v0
        si = cbox.surface_interaction(tri, jnp.zeros((3, 2)))
        np.testing.assert_allclose(
            np.asarray(si["p"]), np.asarray(cbox.arrays.v0[tri]), atol=1e-6
        )
        # frame is orthonormal
        t, b, n = si["frame"]
        np.testing.assert_allclose(np.asarray((t * b).sum(-1)), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(n), axis=-1), 1.0, atol=1e-5)


class TestRenderIntegration:
    def test_small_render_statistics(self, cbox_path):
        """Golden-statistics test: 32x32 cbox render has stable mean brightness."""
        scene = load_scene(cbox_path, width=32, height=32)
        from akari_render.integrators.pt import render_pt

        img, stats = render_pt(scene, PTConfig(spp=16, max_depth=5, spp_per_pass=16))
        assert np.isfinite(img).all()
        mean = img.mean(axis=(0, 1))
        # reference value from 2048-spp 32x32 runs of this renderer on the
        # generated cbox (NEE vs BSDF-only agree to 0.2%) at depth 5
        np.testing.assert_allclose(mean, CBOX_D5_MEAN, rtol=0.15)
        # red wall tints the left, green the right (compare G/R ratios —
        # absolute G>R doesn't hold since base albedo is itself R-heavy)
        left = img[:, :10].mean(axis=(0, 1))
        right = img[:, 22:].mean(axis=(0, 1))
        assert left[0] / left[1] > right[0] / right[1], "left should be redder than right"

    def test_nee_vs_bsdf_sampling_agree(self, cbox_path):
        """The two estimators must converge to the same image (MIS check)."""
        scene = load_scene(cbox_path, width=16, height=16)
        from akari_render.integrators.pt import render_pt

        img_a, _ = render_pt(scene, PTConfig(spp=48, max_depth=4, use_nee=True, spp_per_pass=48))
        img_b, _ = render_pt(scene, PTConfig(spp=48, max_depth=4, use_nee=False, spp_per_pass=48))
        ma, mb = img_a.mean(axis=(0, 1)), img_b.mean(axis=(0, 1))
        np.testing.assert_allclose(ma, mb, rtol=0.1)


class TestSharding:
    def test_multichip_matches_film_weight(self, cbox_path):
        from akari_render.core.film import Film
        from akari_render.core.filters import GaussianFilter
        from akari_render.integrators.common import PTSettings
        from akari_render.parallel.shard import make_mesh, make_sharded_pass

        scene = load_scene(cbox_path, width=16, height=16)
        mesh = make_mesh(8)
        one_pass = make_sharded_pass(
            scene, PTSettings(max_depth=3, rr_depth=2), GaussianFilter(1.5), 16, 16, mesh
        )
        film = Film.new(16, 16)
        film = one_pass(scene.arrays, film, jnp.uint32(0))
        assert float(film.weight.sum()) == 16 * 16  # every pixel sampled once

    def test_sharded_matches_mean(self, cbox_path):
        """8-shard render statistically matches the single-device render."""
        from akari_render.core.film import develop
        from akari_render.parallel.shard import make_mesh, render_pt_sharded

        scene = load_scene(cbox_path, width=16, height=16)
        img, _ = render_pt_sharded(
            scene, PTConfig(spp=32, max_depth=4), mesh=make_mesh(8)
        )
        np.testing.assert_allclose(
            img.mean(axis=(0, 1)), CBOX_D5_MEAN, rtol=0.25
        )


class TestAlphaTraversal:
    """Stochastic alpha-tested traversal (ref scene.rs:42-110): restarts must
    honor the CALLER's exclusion ids (regression: they were dropped after the
    first restart) and skip alpha-rejected candidates."""

    def _build(self, tmp_path, alpha):
        import io
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M
        from PIL import Image

        from akari_render.scenegraph.write import SceneBuilder

        b = SceneBuilder()
        M.quad(b, "front", (-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0))
        M.quad(b, "back", (-2, -2, -1), (2, -2, -1), (2, 2, -1), (-2, 2, -1))
        w = h = 8
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., 3] = int(round(alpha * 255))
        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, format="PNG")
        view = b.add_array("tex.a", np.frombuffer(buf.getvalue(), np.uint8))
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
        b.add_material(
            "alpha_mat",
            M.principled(roughness=0.8, base_color_node=(nodes, {"id": "tex"})),
        )
        b.add_material("solid", M.principled(base_color=(0.5, 0.5, 0.5)))
        eye = np.eye(4).tolist()
        b.add_instance("front_i", "front", eye, ["alpha_mat"])
        b.add_instance("back_i", "back", eye, ["solid"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=8, height=8)
        path = b.write(tmp_path / f"alpha{alpha}", compact=True)
        return load_scene(path)

    def _rays(self, n=64):
        rng = np.random.default_rng(7)
        xy = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        o = jnp.asarray(np.concatenate([xy, np.full((n, 1), 5.0, np.float32)], -1))
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (n, 3))
        tmin = jnp.zeros((n,))
        tmax = jnp.full((n,), 1e8)
        return o, d, tmin, tmax

    def test_alpha_zero_passes_through(self, tmp_path):
        scene = self._build(tmp_path, 0.0)
        assert scene.has_alpha
        o, d, tmin, tmax = self._rays()
        hit = scene.intersect_alpha(o, d, tmin, tmax)
        # front quad = tris 0,1 (instance order); back quad = tris 2,3
        assert bool(jnp.all(hit.valid))
        assert bool(jnp.all(hit.tri_id >= 2))
        np.testing.assert_allclose(np.asarray(hit.t), 6.0, atol=1e-4)

    def test_restart_preserves_caller_exclusions(self, tmp_path):
        """Exclude BOTH back tris (both caller slots used): rays must pass the
        alpha=0 front quad and then MISS — never re-hit an excluded id."""
        scene = self._build(tmp_path, 0.0)
        o, d, tmin, tmax = self._rays()
        base = scene.intersect_alpha(o, d, tmin, tmax)
        ex0 = jnp.full(base.tri_id.shape, 2, jnp.int32)
        ex1 = jnp.full(base.tri_id.shape, 3, jnp.int32)
        hit = scene.intersect_alpha(o, d, tmin, tmax, exclude0=ex0, exclude1=ex1)
        assert not bool(jnp.any(hit.valid & (hit.tri_id >= 2)))
        assert not bool(jnp.any(hit.valid & (hit.tri_id <= 1)))

    def test_alpha_half_is_stochastic(self, tmp_path):
        scene = self._build(tmp_path, 0.5)
        o, d, tmin, tmax = self._rays(n=512)
        hit = scene.intersect_alpha(o, d, tmin, tmax)
        front = float(jnp.mean((hit.tri_id <= 1).astype(jnp.float32)))
        assert 0.3 < front < 0.7  # ~Bernoulli(alpha~0.5) per candidate

    def test_dense_alpha_unbiased(self, tmp_path):
        """Six stacked alpha~0.3 sheets in front of a solid wall: committed
        hits must follow the geometric law (old MAX_ALPHA_RESTARTS=4 bias:
        lanes still rejecting after 4 restarts COMMITTED the rejected sheet,
        inflating sheet hits / starving the wall — round-2 VERDICT weak #7),
        and staged occlude_alpha must agree with the closest-hit walk."""
        import io
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M
        from PIL import Image

        from akari_render.scenegraph.write import SceneBuilder

        b = SceneBuilder()
        NS = 6
        for i in range(NS):
            z = -0.1 * i
            M.quad(b, f"s{i}", (-2, -2, z), (2, -2, z), (2, 2, z), (-2, 2, z))
        M.quad(b, "wall", (-2, -2, -2), (2, -2, -2), (2, 2, -2), (-2, 2, -2))
        w = h = 8
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., 3] = 77  # alpha = 77/255 ~ 0.302
        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, format="PNG")
        view = b.add_array("tex.a", np.frombuffer(buf.getvalue(), np.uint8))
        nodes = {
            "tex": {
                "type": "image",
                "image": {
                    "data": view, "extension": "repeat",
                    "interpolation": "linear", "colorspace": "srgb",
                    "format": "png", "width": w, "height": h, "channels": 4,
                },
            }
        }
        b.add_material(
            "amat", M.principled(roughness=0.8, base_color_node=(nodes, {"id": "tex"}))
        )
        b.add_material("solid", M.principled(base_color=(0.5, 0.5, 0.5)))
        eye = np.eye(4).tolist()
        for i in range(NS):
            b.add_instance(f"s{i}_i", f"s{i}", eye, ["amat"])
        b.add_instance("wall_i", "wall", eye, ["solid"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=8, height=8)
        scene = load_scene(b.write(tmp_path / "dense", compact=True))
        assert scene.has_alpha

        n = 4096
        rng = np.random.default_rng(9)
        xy = rng.uniform(-1.9, 1.9, (n, 2)).astype(np.float32)
        o = jnp.asarray(np.concatenate([xy, np.full((n, 1), 5.0, np.float32)], -1))
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (n, 3))
        tmin = jnp.zeros((n,))
        tmax = jnp.full((n,), 1e8)
        hit = scene.intersect_alpha(o, d, tmin, tmax)
        assert bool(jnp.all(hit.valid))  # the wall is opaque: no escapes
        trans = 1.0 - 77.0 / 255.0
        wall = float(jnp.mean((hit.tri_id >= 2 * NS).astype(jnp.float32)))
        expect = trans ** NS  # ~0.117
        assert abs(wall - expect) < 0.035, (wall, expect)
        # per-sheet commit fractions follow the geometric law too
        for i in range(2):
            f_i = float(
                jnp.mean(((hit.tri_id // 2) == i).astype(jnp.float32))
            )
            e_i = (trans ** i) * (1.0 - trans)
            assert abs(f_i - e_i) < 0.04, (i, f_i, e_i)
        # staged occlusion == committed-hit existence (here: always, wall)
        occ = scene.occlude_alpha(o, d, tmin, tmax)
        assert bool(jnp.all(occ))
        # segment ending before the wall: occluded iff some sheet commits
        occ2 = scene.occlude_alpha(o, d, tmin, jnp.full((n,), 6.5))
        f_occ = float(jnp.mean(occ2.astype(jnp.float32)))
        assert abs(f_occ - (1.0 - expect)) < 0.035, f_occ

    def test_opaque_scene_skips_restarts(self, tmp_path):
        scene = self._build(tmp_path, 1.0)
        # static texel scan proves opacity -> no alpha path at all
        assert not scene.has_alpha
        o, d, tmin, tmax = self._rays()
        hit = scene.intersect_alpha(o, d, tmin, tmax)
        assert bool(jnp.all(hit.tri_id <= 1))


class TestTangents:
    """Stored tangent frames (ref mesh.rs:118-124 mikktspace generation,
    mesh.rs:552-592 stored-tangent interpolation): stored tangents must win
    over the dpdu fallback, and meshes without them get smoothed generated
    tangents that differ from raw per-face dpdu on curved geometry."""

    def _scene_with_tangents(self, tmp_path, tangents):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M

        from akari_render.scenegraph.write import SceneBuilder

        b = SceneBuilder()
        v = np.asarray(
            [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)], np.float32
        )
        idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
        uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
        b.add_mesh("quad", v, idx, uvs=uv, tangents=tangents)
        b.add_material("m", M.principled(base_color=(0.5, 0.5, 0.5)))
        b.add_instance("q", "quad", np.eye(4).tolist(), ["m"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=8, height=8)
        return load_scene(b.write(tmp_path / "tan", compact=True))

    def test_stored_tangent_wins_over_dpdu(self, tmp_path):
        # uv mapping gives dpdu = +x; store +y tangents instead
        t = np.tile(np.asarray([0, 1, 0], np.float32), (6, 1))
        scene = self._scene_with_tangents(tmp_path, t)
        si = scene.surface_interaction(
            jnp.zeros((4,), jnp.int32), jnp.full((4, 2), 0.25)
        )
        tan = np.asarray(si["frame"][0])
        np.testing.assert_allclose(tan, np.tile([0, 1, 0], (4, 1)), atol=1e-5)

    def test_no_tangents_falls_back_to_dpdu(self, tmp_path):
        scene = self._scene_with_tangents(tmp_path, None)
        si = scene.surface_interaction(
            jnp.zeros((4,), jnp.int32), jnp.full((4, 2), 0.25)
        )
        tan = np.asarray(si["frame"][0])
        # dpdu for this uv layout is +x (and so is its smoothed average)
        np.testing.assert_allclose(np.abs(tan[:, 0]), 1.0, atol=1e-4)

    def test_generated_tangents_smooth_on_sphere(self, tmp_path):
        """On a curved mesh the smoothed generated tangent differs from the
        raw per-face dpdu but stays continuous at shared vertices."""
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M

        from akari_render.accel.flatten import _generate_tangents

        V, I = M.uv_sphere(8, 16, radius=1.0)
        # spherical uvs
        th = np.arccos(np.clip(V[:, 1], -1, 1))
        ph = np.arctan2(V[:, 2], V[:, 0])
        uvs = np.stack([ph / (2 * np.pi) + 0.5, th / np.pi], -1)[
            I.reshape(-1)
        ].astype(np.float64)
        tan = _generate_tangents(
            V.astype(np.float64), I.astype(np.int64), uvs.reshape(len(I), 3, 2)
        )
        # corners sharing a vertex index agree exactly (weld-by-vertex)
        flat = tan.reshape(-1, 3)
        ids = I.reshape(-1)
        for vid in np.unique(ids)[:20]:
            rows = flat[ids == vid]
            assert np.abs(rows - rows[0]).max() < 1e-12
        # and tangents are unit + orthogonal-ish to the sphere normal
        inner = np.abs((flat * V[ids]).sum(-1))
        ln = np.linalg.norm(flat, axis=-1)
        ok = ln > 0.5
        assert ok.mean() > 0.9
        assert np.quantile(inner[ok], 0.9) < 0.3


class TestShardedIntegrators:
    """Sharded MCMC/GPT must match their single-chip versions: chain/pixel
    sample streams are keyed by absolute ids, so only float reduction order
    differs (SURVEY.md §2.3 multi-device plan)."""

    def test_mcmc_sharded_matches_single(self, cbox_path):
        from akari_render.config import MCMCConfig
        from akari_render.integrators.mcmc import render_mcmc
        from akari_render.parallel.shard import make_mesh, render_mcmc_sharded

        scene = load_scene(cbox_path, width=8, height=8)
        cfg = MCMCConfig(
            spp=8, max_depth=2, n_chains=64, n_bootstrap=512,
            direct_spp=0, spp_per_pass=8,
        )
        img_s, st_s = render_mcmc_sharded(scene, cfg, mesh=make_mesh(8))
        img_1, st_1 = render_mcmc(scene, cfg)
        assert abs(st_s["b"] - st_1["b"]) < 1e-9
        assert abs(st_s["acceptance"] - st_1["acceptance"]) < 1e-9
        np.testing.assert_allclose(img_s, img_1, rtol=1e-3, atol=1e-4)

    def test_gpt_sharded_matches_single(self, cbox_path):
        from akari_render.config import GPTConfig
        from akari_render.integrators.gpt import render_gpt
        from akari_render.parallel.shard import make_mesh, render_gpt_sharded

        scene = load_scene(cbox_path, width=8, height=8)
        cfg = GPTConfig(spp=2, max_depth=2)
        img_s, _ = render_gpt_sharded(scene, cfg, mesh=make_mesh(8))
        img_1, _ = render_gpt(scene, cfg)
        np.testing.assert_allclose(img_s, img_1, rtol=1e-3, atol=1e-4)

    def test_pt_sharded_adaptive_loop_features(self, cbox_path, tmp_path):
        """Grown-up sharded PT loop: in-jit spp chunking + checkpoint/stats."""
        from akari_render.parallel.shard import make_mesh, render_pt_sharded
        from akari_render.stats import RenderSession

        scene = load_scene(cbox_path, width=16, height=16)
        ck = tmp_path / "pt.ckpt"
        sess = RenderSession(
            name="shard", save_intermediate=False, save_stats=True,
            out_dir=str(tmp_path),
        )
        cfg = PTConfig(spp=8, max_depth=3, spp_per_pass=4)
        img, stats = render_pt_sharded(
            scene, cfg, mesh=make_mesh(8),
            checkpoint_path=str(ck), checkpoint_every=1, session=sess,
        )
        assert stats["spp_total"] == 8
        assert ck.exists()
        assert (tmp_path / "shard.json").exists()
        # resume from checkpoint: no new samples needed
        img2, stats2 = render_pt_sharded(
            scene, cfg, mesh=make_mesh(8), checkpoint_path=str(ck)
        )
        np.testing.assert_allclose(img, img2, atol=1e-6)


class TestTextureFormats:
    """Image-texture decode breadth (ref load.rs:588-614 ImageFormat family:
    png/jpeg/tiff/tga/dds via the image crate, exr as float)."""

    def _scene_with_texture(self, tmp_path, fmt, payload_bytes, w, h, colorspace):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M

        from akari_render.scenegraph.write import SceneBuilder

        b = SceneBuilder()
        M.quad(b, "q", (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0))
        view = b.add_array("tex.fmt", np.frombuffer(payload_bytes, np.uint8))
        nodes = {
            "tex": {
                "type": "image",
                "image": {
                    "data": view,
                    "extension": "repeat",
                    "interpolation": "linear",
                    "colorspace": colorspace,
                    "format": fmt,
                    "width": w,
                    "height": h,
                    "channels": 4,
                },
            }
        }
        b.add_material("m", M.principled(base_color_node=(nodes, {"id": "tex"})))
        b.add_instance("qi", "q", np.eye(4).tolist(), ["m"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=4, height=4)
        return load_scene(b.write(tmp_path / f"tex_{fmt}", compact=True))

    def test_tiff(self, tmp_path):
        import io

        from PIL import Image

        rgba = np.zeros((4, 4, 4), np.uint8)
        rgba[..., 0] = 200
        rgba[..., 3] = 255
        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, format="TIFF")
        s = self._scene_with_texture(tmp_path, "tiff", buf.getvalue(), 4, 4, "srgb")
        tex = np.asarray(s.atlas.data[0])
        np.testing.assert_allclose(tex[..., 0], 200 / 255.0, atol=1e-3)
        np.testing.assert_allclose(tex[..., 3], 1.0, atol=1e-3)

    def test_exr(self, tmp_path):
        from akari_render.core.image_io import write_exr

        hdr = np.zeros((4, 4, 3), np.float32)
        hdr[..., 1] = 3.5  # HDR value beyond 1 survives the float path
        p = tmp_path / "t.exr"
        write_exr(p, hdr)
        s = self._scene_with_texture(
            tmp_path, "exr", p.read_bytes(), 4, 4, "linear"
        )
        tex = np.asarray(s.atlas.data[0])
        np.testing.assert_allclose(tex[..., 1], 3.5, atol=1e-4)
        np.testing.assert_allclose(tex[..., 3], 1.0, atol=1e-6)


class TestMetalBsdf:
    """Named-IOR conductor (svm/eval.py::_metal): the reference's scenegraph
    metal node exists but its surface impl is todo!() (metal.rs:13-17)."""

    def _scene(self, tmp_path, eta="Au"):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
        import make_test_scene as M

        from akari_render.scenegraph.write import SceneBuilder

        b = SceneBuilder()
        M.quad(b, "q", (-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0))
        graph = {
            "nodes": {
                "r": {"type": "float", "value": 0.2},
                "m": {"type": "metal", "eta": eta, "roughness": {"id": "r"}},
                "out": {"type": "output", "node": {"id": "m"}},
            },
            "output": {"id": "out"},
            "kind": "surface",
        }
        b.add_material("gold", graph)
        b.add_instance("qi", "q", np.eye(4).tolist(), ["gold"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=4, height=4)
        return load_scene(b.write(tmp_path / "metal", compact=True))

    def test_normal_incidence_reflectance(self, tmp_path):
        scene = self._scene(tmp_path, "Au")
        si = scene.surface_interaction(
            jnp.zeros((4,), jnp.int32), jnp.full((4, 2), 0.3)
        )
        closures = scene.dispatch_closures(si)
        assert len(closures) == 1
        _, closure = closures[0]
        wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (4, 3))
        alb = np.asarray(closure.albedo(wo))
        # analytic normal-incidence conductor reflectance per channel
        n = np.array([0.143, 0.375, 1.442])
        k = np.array([3.983, 2.386, 1.603])
        r0 = ((n - 1) ** 2 + k**2) / ((n + 1) ** 2 + k**2)
        # gold: red channel high (~0.98), blue much lower (~0.39)
        assert r0[0] > 0.9 and r0[2] < 0.5
        # albedo ordering matches (rough GGX albedo ~ directional-hemispherical)
        assert alb[0, 0] > alb[0, 2]
        assert 0.5 < alb[0, 0] <= 1.05

    def test_renders_finite(self, tmp_path):
        scene = self._scene(tmp_path, "Cu")
        o = jnp.asarray(np.array([[0.5, 0.5, 3.0]], np.float32))
        d = jnp.asarray(np.array([[0.0, 0.0, -1.0]], np.float32))
        hit = scene.intersect(o, d, jnp.zeros(1), jnp.full(1, 1e8))
        assert bool(hit.valid[0])
