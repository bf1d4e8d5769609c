"""Compact NEE light fetch (lights.attr / light_point_attrs).

The NEE path only needs p/ng/area/mat at the sampled light point; the
compact table must reproduce the full surface_interaction values
bit-exactly (same attr rows, same p = v0 + e1*b0 + e2*b1), and a render
through the compact path must equal the AKR_COMPACT_NEE=0 fallback
bit-for-bit. Ref semantics: area.rs:50-106 (sample_direct needs only the
point/normal/area + emission)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from akari_render.lights import (
    light_point_attrs,
    sample_light_point,
    sample_light_point_ex,
)
from akari_render.scene import load_scene


@pytest.fixture(scope="module")
def cbox(cbox_path):
    return load_scene(cbox_path, width=32, height=32)


def test_table_matches_surface_interaction(cbox):
    lights = cbox.arrays.lights
    assert lights.attr is not None
    assert lights.attr.shape == (lights.tri_ids.shape[0], 14)
    key = jax.random.PRNGKey(7)
    n = 256
    u_sel = jax.random.uniform(key, (n,))
    u_smp = jax.random.uniform(jax.random.PRNGKey(8), (n, 2))
    light, lc_pdf, ltri, lprim_pdf, lbary, slot = sample_light_point_ex(
        lights, cbox.arrays, u_sel, u_smp
    )
    lp, lng, larea, lmat = light_point_attrs(lights, slot, lbary)
    si = cbox.surface_interaction(ltri, lbary)
    np.testing.assert_array_equal(np.asarray(lp), np.asarray(si["p"]))
    np.testing.assert_array_equal(np.asarray(lng), np.asarray(si["ng"]))
    np.testing.assert_array_equal(np.asarray(larea), np.asarray(si["area"]))
    np.testing.assert_array_equal(np.asarray(lmat), np.asarray(si["mat"]))


def test_sample_light_point_delegates(cbox):
    """The 5-tuple API is the ex-API minus the slot (callers unaffected)."""
    lights = cbox.arrays.lights
    u_sel = jnp.linspace(0.0, 0.999, 64)
    u_smp = jnp.stack([jnp.linspace(0, 0.9, 64)] * 2, -1)
    a = sample_light_point(lights, cbox.arrays, u_sel, u_smp)
    b = sample_light_point_ex(lights, cbox.arrays, u_sel, u_smp)
    assert len(a) == 5 and len(b) == 6
    for x, y in zip(a, b[:5]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_render_bit_identical_to_fallback(cbox_path, monkeypatch):
    from akari_render.config import PTConfig
    from akari_render.integrators.pt import render_pt

    def render(flag):
        # the flag is read ONCE at module import (ADVICE r4) — tests flip
        # the module constant, not the env, and must clear jit caches
        from akari_render.integrators import common

        monkeypatch.setattr(common, "_COMPACT_NEE", flag == "1")
        jax.clear_caches()
        scene = load_scene(cbox_path, width=32, height=32)
        img, _ = render_pt(
            scene, PTConfig(spp=4, max_depth=4, spp_per_pass=4)
        )
        return np.asarray(img)

    a = render("1")
    b = render("0")
    assert a.mean() > 0.01  # lit
    np.testing.assert_array_equal(a, b)
