"""Spectral transport (hero-wavelength) tests.

The reference declares spectral types but every spectral path is todo!()
(color.rs:71-73, texture/mod.rs:39-42); this repo implements the transport:
rgb2spec uplift per bounce factor, D65-shaped emission, CIE-sensor film
estimate. The key property: on a scene whose materials are RGB-defined,
the spectral render must agree with the RGB render within MC noise
(the uplift round trip is sub-1% off gamut edges, ~4% at saturated red).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from conftest import CBOX_SCENE

jnp = pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def table():
    from akari_render.core.spectral import ensure_rgb2spec_table

    tab = ensure_rgb2spec_table()
    if tab is None:
        pytest.skip("native rgb2spec optimizer unavailable")
    return tab


def test_sensor_whitepoint():
    """A flat-reflectance D65 emitter is sRGB white (the sensor's own
    normalization, independent of the uplift table)."""
    from akari_render.core.spectral import illuminant_d65, spectral_to_rgb

    lam = jnp.linspace(360.0, 830.0, 4701)[None, :]
    L = illuminant_d65(lam)
    pdf = jnp.full_like(lam, 1.0 / 470.0)
    rgb = np.asarray(spectral_to_rgb(L, lam, pdf))[0]
    assert np.allclose(rgb, 1.0, atol=2e-3), rgb


def test_uplift_round_trip(table):
    """uplift -> spectrum * D65 -> CIE sensor reproduces the input RGB."""
    from akari_render.core.spectral import (
        eval_reflectance, illuminant_d65, spectral_to_rgb, uplift_unbounded,
    )

    lam = jnp.linspace(360.0, 830.0, 4701)[None, :]
    pdf = jnp.full_like(lam, 1.0 / 470.0)
    cases = [
        [0.14, 0.45, 0.091], [0.725, 0.71, 0.68], [1.0, 1.0, 1.0],
        [0.1, 0.3, 0.8], [0.01, 0.01, 0.01], [5.0, 5.0, 5.0], [2.0, 8.0, 3.0],
    ]
    for rgb in cases:
        r = jnp.array([rgb])
        c, s = uplift_unbounded(table, r)
        spec = eval_reflectance(c, lam) * s[..., None] * illuminant_d65(lam)
        out = np.asarray(spectral_to_rgb(spec, lam, pdf))[0]
        rel = np.max(np.abs(out - np.array(rgb)) / np.maximum(np.array(rgb), 1e-3))
        assert rel < 0.02, (rgb, out, rel)
    # saturated gamut-edge red: looser (sigmoid fit limitation)
    r = jnp.array([[0.63, 0.065, 0.05]])
    c, s = uplift_unbounded(table, r)
    spec = eval_reflectance(c, lam) * s[..., None] * illuminant_d65(lam)
    out = np.asarray(spectral_to_rgb(spec, lam, pdf))[0]
    assert np.max(np.abs(out - np.array([0.63, 0.065, 0.05]))) < 0.05


def test_wavelength_sample_pdf():
    from akari_render.core.spectral import sample_wavelengths

    sw = sample_wavelengths(jnp.array([0.0, 0.3, 0.999]))
    lam = np.asarray(sw.lambdas)
    assert lam.shape == (3, 4)
    assert np.all(lam >= 360.0) and np.all(lam <= 830.0)
    # stratified: the 4 hero offsets cover distinct quarters
    q = ((lam - 360.0) / 470.0 * 4).astype(int)
    for row in q:
        assert sorted(set(row.tolist())) == [0, 1, 2, 3]
    assert np.allclose(np.asarray(sw.pdf), 1.0 / 470.0)


def test_spectral_cbox_matches_rgb(table):
    """End-to-end: spectral PT == RGB PT within MC noise on cbox.

    Path decisions are bit-identical between modes (RGB beta drives RR in
    both); only the accumulation differs, so the residual is wavelength MC
    noise + uplift bias, both well under the seed-to-seed noise floor
    (measured: spectral-vs-rgb MSE 0.0048 < seed-vs-seed MSE 0.0081 at
    64^2/64spp)."""
    from akari_render.config import PTConfig
    from akari_render.integrators.pt import render_pt
    from akari_render.scene import load_scene

    scene = load_scene(
        CBOX_SCENE, width=48, height=48
    )
    cfg = PTConfig(spp=48, max_depth=5, spp_per_pass=48)
    img_rgb, _ = render_pt(scene, cfg)
    img_s, _ = render_pt(scene, dataclasses.replace(cfg, color="spectral"))
    a, b = np.asarray(img_rgb), np.asarray(img_s)
    assert np.all(np.isfinite(b))
    # global + per-channel energy agreement (bias test)
    assert abs(b.mean() - a.mean()) / a.mean() < 0.04
    ca, cb = a.mean((0, 1)), b.mean((0, 1))
    assert np.all(np.abs(cb - ca) / np.maximum(ca, 1e-3) < 0.08), (ca, cb)
    # pixelwise agreement within the MC-noise envelope
    assert float(np.mean((b - a) ** 2)) < 0.02


def test_spectral_config_parsing():
    from akari_render.config import PTConfig

    assert PTConfig.from_json({"color": "spectral"}).color == "spectral"
    assert PTConfig.from_json({"color": {"type": "spectral"}}).color == "spectral"
    assert PTConfig.from_json({}).color == "rgb"
    assert PTConfig.from_json({"color": {"type": "rgb", "colorspace": "srgb"}}).color == "rgb"
