"""Scene write/load round-trip, import API, checkpointing, stats."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from conftest import CBOX_SCENE, CLASSROOM_SCENE

pytestmark = pytest.mark.slow  # see pytest.ini: statistical / E2E tier

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


class TestSceneWrite:
    def test_matbox_roundtrip(self, tmp_path):
        import make_test_scene

        path = make_test_scene.build(tmp_path / "matbox")
        assert path.exists()
        doc = json.loads(path.read_text())
        assert set(doc["buffers"]) == {"Scene"}  # compacted
        from akari_render.scene import load_scene

        s = load_scene(path, width=16, height=16)
        assert s.num_tris > 4000
        assert len(s.kinds) == 4  # principled / diffuse+checker / glass / textured
        assert s.arrays.lights.num_lights == 1
        assert s.atlas is not None

    def test_matbox_renders(self, tmp_path):
        import make_test_scene

        path = make_test_scene.build(tmp_path / "matbox")
        from akari_render.config import PTConfig
        from akari_render.integrators.pt import render_pt
        from akari_render.scene import load_scene

        s = load_scene(path, width=24, height=24)
        img, _ = render_pt(s, PTConfig(spp=4, max_depth=4, spp_per_pass=4))
        assert np.isfinite(img).all()
        assert img.mean() > 0.05  # lit scene

    def test_api_commands(self, tmp_path):
        from akari_render.api import SceneImportApi

        api = SceneImportApi()
        api.execute({"type": "init"})
        api.execute(
            {
                "type": "import_mesh",
                "data": {
                    "name": "tri",
                    "vertices": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    "indices": [[0, 1, 2]],
                },
            }
        )
        api.execute(
            {
                "type": "import_material",
                "data": {
                    "name": "m",
                    "shader_graph": {
                        "nodes": {
                            "c": {"type": "rgb", "value": [1, 0, 0], "colorspace": "srgb"},
                            "u": {"type": "spectral_uplift", "rgb": {"id": "c"}},
                            "b": {"type": "diffuse", "color": {"id": "u"}},
                            "o": {"type": "output", "node": {"id": "b"}},
                        },
                        "output": {"id": "o"},
                        "kind": "surface",
                    },
                },
            }
        )
        api.execute(
            {
                "type": "import_instance",
                "data": {
                    "name": "i",
                    "geometry": "tri",
                    "matrix": np.eye(4).tolist(),
                    "materials": ["m"],
                },
            }
        )
        api.execute(
            {
                "type": "import_camera",
                "data": {"transform_matrix": np.eye(4).tolist(), "fov_deg": 45, "width": 8, "height": 8},
            }
        )
        out = api.execute({"type": "write_scene", "data": {"out_dir": str(tmp_path / "s")}})
        from akari_render.scene import load_scene

        s = load_scene(out["path"])
        assert s.num_tris == 1


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        from akari_render.checkpoint import load_checkpoint, save_checkpoint
        from akari_render.core.film import Film

        film = Film(
            accum=jnp.ones((16, 3)), splat=jnp.zeros((16, 3)), weight=jnp.full((16,), 2.0)
        )
        p = tmp_path / "ck.npz"
        save_checkpoint(p, film, {"kind": "pt", "passes_done": 7}, {"rng": np.arange(4)})
        film2, meta, extra = load_checkpoint(p)
        assert meta["passes_done"] == 7
        np.testing.assert_array_equal(np.asarray(film2.weight), np.asarray(film.weight))
        np.testing.assert_array_equal(extra["rng"], np.arange(4))

    def test_missing_returns_none(self, tmp_path):
        from akari_render.checkpoint import load_checkpoint

        assert load_checkpoint(tmp_path / "nope.npz") is None

    def test_pt_resume_continues(self, cbox_path, tmp_path):
        from akari_render.config import PTConfig
        from akari_render.integrators.pt import render_pt
        from akari_render.scene import load_scene

        s = load_scene(cbox_path, width=8, height=8)
        ck = tmp_path / "r.npz"
        cfg = PTConfig(spp=8, max_depth=3, spp_per_pass=2)
        img_full, _ = render_pt(s, cfg)
        # run once with checkpoints, then resume (checkpoint at pass 2 of 4)
        render_pt(s, cfg, checkpoint_path=ck, checkpoint_every=2)
        assert ck.exists()
        img_resumed, _ = render_pt(s, cfg, checkpoint_path=ck, checkpoint_every=0)
        np.testing.assert_allclose(img_resumed, img_full, atol=1e-5)

    def test_mcmc_resume_continues(self, cbox_path, tmp_path):
        """Kill-and-resume equality: chains checkpointed at half the
        mutation budget continue to the full budget bit-identically
        (SURVEY.md §5 film + chain state)."""
        from akari_render.config import MCMCConfig
        from akari_render.integrators.mcmc import render_mcmc
        from akari_render.scene import load_scene

        s = load_scene(cbox_path, width=8, height=8)
        ck = tmp_path / "m.npz"
        kw = dict(max_depth=3, n_chains=32, n_bootstrap=256, direct_spp=0,
                  spp_per_pass=2)
        img_full, st_full = render_mcmc(s, MCMCConfig(spp=8, **kw))
        # half-budget run leaves a mid-render checkpoint...
        render_mcmc(s, MCMCConfig(spp=4, **kw), checkpoint_path=ck,
                    checkpoint_every=1)
        assert ck.exists()
        # ...which the full-budget run resumes and completes
        img_resumed, st_res = render_mcmc(
            s, MCMCConfig(spp=8, **kw), checkpoint_path=ck, checkpoint_every=0
        )
        assert st_res["b"] == st_full["b"]
        np.testing.assert_allclose(img_resumed, img_full, atol=1e-5)

    def test_gpt_resume_continues(self, cbox_path, tmp_path):
        from akari_render.config import GPTConfig
        from akari_render.integrators.gpt import render_gpt
        from akari_render.scene import load_scene

        s = load_scene(cbox_path, width=8, height=8)
        ck = tmp_path / "g.npz"
        kw = dict(max_depth=3, reconstruction_iter=8)
        img_full, _ = render_gpt(s, GPTConfig(spp=2, **kw))
        render_gpt(s, GPTConfig(spp=1, **kw), checkpoint_path=ck,
                   checkpoint_every=1)
        assert ck.exists()
        img_resumed, _ = render_gpt(
            s, GPTConfig(spp=2, **kw), checkpoint_path=ck, checkpoint_every=0
        )
        np.testing.assert_allclose(img_resumed, img_full, atol=1e-5)


class TestStats:
    def test_stats_format(self, tmp_path):
        from akari_render.stats import DispatchProfiler, RenderSession, RenderStats

        st = RenderStats()
        st.record(1.5, 16, "a.exr")
        st.record(3.0, 32, "b.exr")
        p = st.write(RenderSession(name="t", out_dir=str(tmp_path)))
        doc = json.loads(p.read_text())
        assert doc["intermediate"][1] == {"time": 3.0, "spp": 32, "path": "b.exr"}

        prof = DispatchProfiler()
        with prof.profile("stage"):
            pass
        rep = prof.report()
        assert rep["stage"]["count"] == 1


class TestDisplayServer:
    """HTTP progressive preview (gui.py — the DisplayChannel analog of
    gui.rs:18-110, headless-host edition)."""

    def test_serves_frames(self):
        import urllib.request

        from akari_render.gui import DisplayServer

        srv = DisplayServer()
        try:
            html = urllib.request.urlopen(srv.url, timeout=5).read()
            assert b"frame.png" in html
            img = np.zeros((8, 8, 3), np.float32)
            img[:, :, 1] = 0.5
            srv.update(img)
            png = urllib.request.urlopen(srv.url + "frame.png", timeout=5).read()
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            from io import BytesIO

            from PIL import Image

            decoded = np.asarray(Image.open(BytesIO(png)))
            assert decoded.shape[:2] == (8, 8)
            assert decoded[..., 1].mean() > decoded[..., 0].mean()
        finally:
            srv.close()

    def test_render_pushes_frames(self, tmp_path):
        from akari_render.config import PTConfig
        from akari_render.integrators.pt import render_pt
        from akari_render.scene import load_scene
        from akari_render.stats import RenderSession

        frames = []
        sess = RenderSession(display=lambda im: frames.append(im.shape))
        s = load_scene(CBOX_SCENE, width=8, height=8)
        render_pt(s, PTConfig(spp=2, max_depth=2, spp_per_pass=1), session=sess)
        assert frames and frames[-1] == (8, 8, 3)


def test_render_task_multi(tmp_path):
    """RenderTask::Multi (ref lib.rs:103-109): a method file holding a JSON
    list renders each config in sequence against the same scene."""
    import json as _json

    from akari_render.cli import main

    multi = [
        {"method": {"type": "pt", "spp": 1, "max_depth": 2},
         "film": {"out": str(tmp_path / "a.exr")}},
        {"method": {"type": "pt", "spp": 1, "max_depth": 2},
         "film": {"out": str(tmp_path / "b.exr")}},
    ]
    mp = tmp_path / "multi.json"
    mp.write_text(_json.dumps(multi))
    main(["-s", CBOX_SCENE, "-m", str(mp), "--res", "8"])
    assert (tmp_path / "a.exr").exists() and (tmp_path / "b.exr").exists()


@pytest.mark.parametrize("scene_path", [CBOX_SCENE, CLASSROOM_SCENE])
def test_lane_cap_bounds_cull_buffers(scene_path, monkeypatch):
    """max_wavefront_lanes keeps the cluster cull's [lanes, min(K,
    CULL_CHUNK)] f32 buffers at or under 2^26 elements on cluster-tier
    scenes, and gives brute-tier scenes the flat 2^22-lane cap."""
    from akari_render.accel.cluster import CULL_CHUNK
    from akari_render.integrators.pt import max_wavefront_lanes
    from akari_render.scene import load_scene

    monkeypatch.delenv("AKR_MAX_LANES", raising=False)
    scene = load_scene(scene_path, width=64, height=64)
    cap = max_wavefront_lanes(scene)
    a = scene.arrays
    if a.bvh is None and a.instanced is None:
        assert cap == 1 << 22
        return
    k = 0
    if a.bvh is not None:
        k = max(k, min(a.bvh["clusters"].num_clusters, CULL_CHUNK))
    if a.instanced is not None:
        k = max(k, min(int(a.instanced.clusters.cbmin.shape[0]), CULL_CHUNK))
    assert cap >= 1 << 16
    assert cap * k <= max(1 << 26, (1 << 16) * k)


def test_split_compacted_pass_bit_exact(monkeypatch):
    """Round-5 split-compacted pass (pt.py::_render_pass_fn_split): depths
    past AKR_SPLIT_DEPTH re-dispatch on live-lane-compacted chunks. Lanes
    are independent, so compaction is a pure row permutation and the image
    must be BIT-identical to the unsplit pass — including lanes that died
    before the split depth (clamped in the combine step) and chunk-straddle
    rows (idempotent scatter)."""
    import numpy as np

    from akari_render.config import PTConfig
    from akari_render.integrators.pt import render_pt
    from akari_render.scene import load_scene

    scene = load_scene(
        CBOX_SCENE, width=48, height=48
    )
    cfg = PTConfig(spp=6, max_depth=7, spp_per_pass=6)
    monkeypatch.delenv("AKR_SPLIT_DEPTH", raising=False)
    a = np.asarray(render_pt(scene, cfg)[0])
    monkeypatch.setenv("AKR_SPLIT_DEPTH", "2")
    monkeypatch.setenv("AKR_SPLIT_FRAC", "4")
    b = np.asarray(render_pt(scene, cfg)[0])
    assert (a == b).all(), float(np.max(np.abs(a - b)))
