"""Persistent-wavefront PT (integrators/wavefront.py) vs the pass-based
path tracer. Per-item radiance uses identical sampler streams keyed by
(pixel, sample), so the two must agree to fp-accumulation tolerance."""
import numpy as np
import pytest

from akari_render.config import PTConfig
from akari_render.integrators.pt import render_pt
from akari_render.integrators.wavefront import render_pt_wavefront
from akari_render.scene import load_scene
from conftest import CBOX_SCENE


@pytest.fixture(scope="module")
def cbox():
    return load_scene(
        CBOX_SCENE, width=32, height=32
    )


def test_matches_pass_based(cbox):
    cfg = PTConfig(spp=4, max_depth=5, rr_depth=3)
    img_p, _ = render_pt(cbox, cfg)
    img_w, _ = render_pt_wavefront(cbox, cfg)
    np.testing.assert_allclose(img_w, img_p, rtol=2e-4, atol=2e-5)


def test_matches_with_small_pool(cbox, monkeypatch):
    """Force a pool smaller than the frame so the queue actually cycles
    (many refills per pass) and the capped-dispatch path executes."""
    monkeypatch.setenv("AKR_MAX_LANES", "1024")
    monkeypatch.setenv("AKR_WF_ITERS", "7")
    cfg = PTConfig(spp=2, max_depth=4, rr_depth=2)
    img_p, _ = render_pt(cbox, cfg)
    img_w, _ = render_pt_wavefront(cbox, cfg)
    np.testing.assert_allclose(img_w, img_p, rtol=2e-4, atol=2e-5)


def test_deep_config_with_rr(cbox):
    """rr_depth < max_depth exercises per-lane RR death + refill."""
    cfg = PTConfig(spp=2, max_depth=8, rr_depth=1)
    img_p, _ = render_pt(cbox, cfg)
    img_w, _ = render_pt_wavefront(cbox, cfg)
    np.testing.assert_allclose(img_w, img_p, rtol=2e-4, atol=2e-5)


def test_wavefront_pmj02_sampler(cbox):
    """Regression: the pmj02 sampler pytree carries a SHARED sample-table
    leaf; the refill's lane select must pass it through instead of masking
    it per-lane (which raised a broadcast error through the CLI path,
    where pt.json selects pmj02bn)."""
    from akari_render.config import RenderTask

    task = RenderTask(method_type="pt", method=None,
                      sampler={"type": "pmj02bn", "seed": 0})
    cfg = PTConfig(spp=4, max_depth=4, rr_depth=3, spp_per_pass=4)
    img_p, _ = render_pt(cbox, cfg, task=task)
    img_w, _ = render_pt_wavefront(cbox, cfg, task=task)
    np.testing.assert_allclose(img_w, img_p, rtol=2e-4, atol=2e-5)


def test_wavefront_sharded_matches_single(cbox):
    """8-device persistent wavefront: every (pixel, sample) path is sampled
    with the same GLOBAL keying as single-chip, so the developed image
    matches to fp-accumulation tolerance (retirement order differs)."""
    from akari_render.parallel.shard import (
        make_mesh, render_pt_wavefront_sharded,
    )

    cfg = PTConfig(spp=8, max_depth=4, rr_depth=3, spp_per_pass=8)
    img_single, _ = render_pt_wavefront(cbox, cfg)
    img_s, st = render_pt_wavefront_sharded(cbox, cfg, mesh=make_mesh(8))
    assert st["devices"] == 8
    np.testing.assert_allclose(img_s, img_single, rtol=2e-4, atol=2e-5)


def test_wavefront_fused_matches_sequential(cbox):
    """AKR_FUSE_RAYS in the persistent wavefront: pending NEE shadows ride
    the next bounce's traversal; contribution values unchanged (only float
    accumulation order moves)."""
    import os

    from akari_render.config import PTConfig
    from akari_render.integrators.wavefront import render_pt_wavefront

    cfg = PTConfig(spp=8, max_depth=6, rr_depth=3, spp_per_pass=8)
    img_seq, _ = render_pt_wavefront(cbox, cfg)
    os.environ["AKR_FUSE_RAYS"] = "1"
    try:
        img_fused, _ = render_pt_wavefront(cbox, cfg)
    finally:
        del os.environ["AKR_FUSE_RAYS"]
    assert np.isfinite(img_fused).all()
    assert np.allclose(img_seq, img_fused, rtol=1e-4, atol=1e-5), (
        float(np.max(np.abs(img_seq - img_fused))))
