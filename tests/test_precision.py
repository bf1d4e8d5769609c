"""Every f32 contraction on the render path asks for full f32 precision.

A float32 dot_general without an explicit precision may run in TF32 on a
GPU, which keeps about three decimal digits: enough to terrace vertex
positions and instance transforms. This scans the jaxpr of whole PT
bounces for every dot_general with a float32 operand."""
import sys
from pathlib import Path

import jax
import jax.extend
import jax.numpy as jnp
import pytest
from conftest import CBOX_SCENE, CLASSROOM_SCENE, MATBOX_SCENE

from akari_render.camera import generate_rays
from akari_render.core.lds import make_sampler
from akari_render.integrators.common import PTSettings, trace_paths
from akari_render.scene import load_scene

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import precision_control  # noqa: E402


def _eqns(jaxpr, primitive):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == primitive:
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr, primitive)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub, primitive)


def _is_highest(precision):
    if precision is None:
        return False
    ps = precision if isinstance(precision, tuple) else (precision,)
    return all(p == jax.lax.Precision.HIGHEST for p in ps)


@pytest.mark.parametrize(
    "scene_path,color",
    [(CBOX_SCENE, "rgb"), (CLASSROOM_SCENE, "rgb"), (MATBOX_SCENE, "rgb"),
     (CBOX_SCENE, "spectral")],
    ids=["cbox", "classroom", "matbox", "cbox-spectral"],
)
def test_every_f32_dot_is_highest(scene_path, color):
    assert not _loose_f32_dots(_bounce_jaxpr(scene_path, color))


@pytest.mark.parametrize(
    "scene_path,color",
    [(CLASSROOM_SCENE, "rgb"), (CBOX_SCENE, "spectral")],
    ids=["classroom", "cbox-spectral"],
)
def test_precision_control_faults_the_bounce(scene_path, color):
    """tools/precision_control.py really faults the bounce's contractions
    (instance, albedo-table and colour transforms), both ways, and puts
    them back afterwards."""
    with precision_control.default_precision_sites():
        assert _loose_f32_dots(_bounce_jaxpr(scene_path, color))
    sound = _bounce_jaxpr(scene_path, color)
    assert not _loose_f32_dots(sound)
    with precision_control.tf32_operands():
        faulted = _bounce_jaxpr(scene_path, color)
    n_rounded = len(list(_eqns(faulted.jaxpr, "reduce_precision")))
    assert n_rounded > len(list(_eqns(sound.jaxpr, "reduce_precision")))
    assert not _loose_f32_dots(_bounce_jaxpr(scene_path, color))


def _loose_f32_dots(jaxpr):
    """Source lines of the f32 dot_generals below HIGHEST."""
    dots = list(_eqns(jaxpr.jaxpr, "dot_general"))
    assert dots, "no contraction found: the scan sees nothing"
    return [
        str(e.source_info.traceback).splitlines()[-1] if e.source_info else str(e)
        for e in dots
        if any(v.aval.dtype == jnp.float32 for v in e.invars)
        and not _is_highest(e.params.get("precision"))
    ]


def _bounce_jaxpr(scene_path, color):
    scene = load_scene(scene_path, width=8, height=8)
    settings = PTSettings(max_depth=3, rr_depth=2, color=color)
    n = 64

    def bounce(arrays):
        from dataclasses import replace

        sc = replace(scene, arrays=arrays)
        pix = jnp.arange(n, dtype=jnp.uint32)
        sampler = make_sampler(None, pix, jnp.uint32(0), 0)
        sampler, u = sampler.next_2d()
        p_film = jnp.stack([(pix % 8), (pix // 8)], -1).astype(jnp.float32) + u
        o, d = generate_rays(sc.camera, p_film)
        spectral = None
        if color == "spectral":
            from akari_render.core.spectral import sample_wavelengths

            sampler, u_lam = sampler.next_1d()
            spectral = sample_wavelengths(u_lam)
        return trace_paths(sc, settings, o, d, sampler, spectral=spectral)[0]

    return jax.make_jaxpr(bounce)(scene.arrays)
