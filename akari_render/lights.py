"""Area lights: power-weighted light selection + per-light triangle sampling.

Reference: crates/akari_render/src/light/{mod.rs,area.rs} — a
WeightedLightDistribution (alias table over per-instance emission power)
selects a light; the light's per-triangle AliasTable picks a primitive;
uniform-triangle sampling gives the point; pdf is converted to solid angle.

Array layout: all per-light triangle alias tables are concatenated into flat
arrays with (offset, count) per light — one gather-based sampler for every
light in the scene, no polymorphic dispatch needed (only area lights exist in
the reference; point.rs is an unused stub).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .core.distribution import AliasTable
from .core.math import dot, face_forward, length_squared, normalize, offset_ray_origin
from .core.sampling import uniform_sample_triangle


class LightArrays(NamedTuple):
    """Device pytree for all area lights."""

    # light selection (power-weighted)
    sel_prob: jnp.ndarray  # [L]
    sel_alias: jnp.ndarray  # [L]
    sel_pdf: jnp.ndarray  # [L]
    # concatenated per-light triangle alias tables
    tri_prob: jnp.ndarray  # [S]
    tri_alias: jnp.ndarray  # [S]
    tri_pdf: jnp.ndarray  # [S]
    tri_ids: jnp.ndarray  # [S] global triangle id for each table entry
    offset: jnp.ndarray  # [L]
    count: jnp.ndarray  # [L]
    # reverse maps
    tri_prim_pdf: jnp.ndarray  # [T] pdf of tri within its light (0 if not a light)
    tri_light_id: jnp.ndarray  # [T] int32 light id or -1
    # compact per-table-entry geometry for the NEE fetch: [S, 14]
    # (v0[3], e1[3], e2[3], ng[3], area, mat) — aligned with tri_ids. The
    # full surface_interaction fetches 41 attribute columns and builds
    # shading frames/tangents the light sample never uses; this table lets
    # the NEE path fetch exactly what finish_light_sample + the constant
    # emission lookup need (light_point_attrs below). None until load_scene
    # fills it (placeholder scenes / L == 0).
    attr: jnp.ndarray | None = None

    @property
    def num_lights(self) -> int:
        return self.sel_prob.shape[0]

    @staticmethod
    def build(light_powers: list[np.ndarray], light_tri_ids: list[np.ndarray], num_tris: int) -> "LightArrays":
        """light_powers[l]: per-triangle power array of light l;
        light_tri_ids[l]: global triangle ids of light l."""
        L = len(light_powers)
        if L == 0:
            z = jnp.zeros((0,), jnp.float32)
            zi = jnp.zeros((0,), jnp.int32)
            return LightArrays(
                sel_prob=z, sel_alias=zi, sel_pdf=z,
                tri_prob=z, tri_alias=zi, tri_pdf=z, tri_ids=zi,
                offset=zi, count=zi,
                tri_prim_pdf=jnp.zeros((num_tris,), jnp.float32),
                tri_light_id=jnp.full((num_tris,), -1, jnp.int32),
            )
        totals = np.array([p.sum() for p in light_powers], np.float64)
        sel = AliasTable.build(totals)
        tabs = [AliasTable.build(p) for p in light_powers]
        counts = np.array([len(p) for p in light_powers], np.int32)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        tri_prim_pdf = np.zeros(num_tris, np.float32)
        tri_light_id = np.full(num_tris, -1, np.int32)
        for l, (tab, ids) in enumerate(zip(tabs, light_tri_ids)):
            tri_prim_pdf[ids] = np.asarray(tab.pdf)
            tri_light_id[ids] = l
        return LightArrays(
            sel_prob=sel.prob,
            sel_alias=sel.alias.astype(jnp.int32),
            sel_pdf=sel.pdf,
            tri_prob=jnp.concatenate([t.prob for t in tabs]),
            tri_alias=jnp.concatenate([t.alias.astype(jnp.int32) for t in tabs]),
            tri_pdf=jnp.concatenate([t.pdf for t in tabs]),
            tri_ids=jnp.asarray(np.concatenate(light_tri_ids).astype(np.int32)),
            offset=jnp.asarray(offsets),
            count=jnp.asarray(counts),
            tri_prim_pdf=jnp.asarray(tri_prim_pdf),
            tri_light_id=jnp.asarray(tri_light_id),
        )


def _alias_sample(prob, alias, pdf, base, count, u):
    """Sample from a sub-table [base, base+count) (distribution.rs:61-89)."""
    scaled = u * count.astype(jnp.float32)
    i = jnp.clip(scaled.astype(jnp.int32), 0, count - 1)
    frac = scaled - i.astype(jnp.float32)
    gi = base + i
    p = prob[gi]
    take_own = frac < p
    out = jnp.where(take_own, i, alias[gi])
    remapped = jnp.where(
        take_own, frac / jnp.maximum(p, 1e-20), (frac - p) / jnp.maximum(1.0 - p, 1e-20)
    )
    return out, pdf[base + out], jnp.clip(remapped, 0.0, 1.0)


class LightSample(NamedTuple):
    li: jnp.ndarray  # [N, 3] radiance (zero if invalid/backfacing)
    pdf: jnp.ndarray  # [N] solid-angle pdf (x light-choice pdf)
    wi: jnp.ndarray  # [N, 3]
    shadow_ro: jnp.ndarray  # [N, 3]
    shadow_dist: jnp.ndarray  # [N]
    dest_tri: jnp.ndarray  # [N] sampled triangle id (shadow-ray exclusion)
    n: jnp.ndarray  # [N, 3] light normal
    tri_id: jnp.ndarray  # [N]
    bary: jnp.ndarray  # [N, 2]
    valid: jnp.ndarray  # [N] bool


def sample_light_point(lights: LightArrays, scene_geo, u_select, u_sample):
    """Pick (light, triangle, barycentric point): the geometric half of
    AreaLight::sample_direct (area.rs:50-70). Returns per-lane triangle data;
    emission evaluation happens in the caller (needs the SVM)."""
    return sample_light_point_ex(lights, scene_geo, u_select, u_sample)[:5]


def sample_light_point_ex(lights: LightArrays, scene_geo, u_select, u_sample):
    """sample_light_point + the sampled table SLOT (index into the
    concatenated per-light tables / lights.attr rows) for the compact
    NEE attribute fetch."""
    L = lights.num_lights
    # light pick
    scaled = u_select * L
    li_ = jnp.clip(scaled.astype(jnp.int32), 0, L - 1)
    frac = scaled - li_.astype(jnp.float32)
    p = lights.sel_prob[li_]
    take_own = frac < p
    light = jnp.where(take_own, li_, lights.sel_alias[li_])
    u_rem = jnp.where(
        take_own, frac / jnp.maximum(p, 1e-20), (frac - p) / jnp.maximum(1.0 - p, 1e-20)
    )
    light_choice_pdf = lights.sel_pdf[light]
    # triangle pick within light
    base = lights.offset[light]
    count = lights.count[light]
    local_tri, prim_pdf, _ = _alias_sample(
        lights.tri_prob, lights.tri_alias, lights.tri_pdf, base, count, jnp.clip(u_rem, 0.0, 1.0 - 1e-7)
    )
    slot = base + local_tri
    tri = lights.tri_ids[slot]
    bary = uniform_sample_triangle(u_sample)
    return light, light_choice_pdf, tri, prim_pdf, bary, slot


# one-hot-matmul cutoff for the compact table (same rationale as
# Scene.ONE_HOT_MAX_TRIS: below this one [N, S] @ [S, 14] matmul; above it
# a 56 B row gather)
LIGHT_ATTR_ONE_HOT_MAX = 2048


def light_point_attrs(lights: LightArrays, slot, bary):
    """Compact NEE fetch at a sampled table slot: (p, ng, area, mat).

    Replaces the full surface_interaction(ltri, lbary) on the light point —
    the full fetch pulls 41 columns and builds shading frames/tangents that
    finish_light_sample never reads. Bit-identical attribute values: rows are copied from
    the same attr matrix and p uses the same v0 + e1*b0 + e2*b1 formula."""
    import jax

    la = lights.attr
    s_total = la.shape[0]
    if s_total <= LIGHT_ATTR_ONE_HOT_MAX:
        oh = jax.nn.one_hot(slot, s_total, dtype=jnp.float32)
        rows = jnp.matmul(oh, la, precision=jax.lax.Precision.HIGHEST)
    else:
        # no clip: slot comes from base + alias-sampled local index, always
        # in [0, S) by construction (a clip would silently remap
        # an out-of-range slot to a valid row; the one-hot branch would
        # yield zeros — let a bug surface as an obviously-wrong gather
        # instead of a plausible wrong light)
        rows = la[slot]
    b0 = bary[..., 0:1]
    b1 = bary[..., 1:2]
    p = rows[..., 0:3] + rows[..., 3:6] * b0 + rows[..., 6:9] * b1
    ng = rows[..., 9:12]
    area = rows[..., 12]
    mat = rows[..., 13].astype(jnp.int32)
    return p, ng, area, mat


def finish_light_sample(
    light_choice_pdf, prim_pdf, tri, bary, emission, p_light, n_light, area, pn_p, pn_n
) -> LightSample:
    """Solid-angle pdf conversion + shadow ray setup (area.rs:64-106)."""
    wi_raw = p_light - pn_p
    dist2 = length_squared(wi_raw)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-30))
    wi = wi_raw / dist[..., None]
    front = dot(wi, n_light) < 0.0
    li = jnp.where(front[..., None], emission, 0.0)
    cos_theta = jnp.abs(dot(n_light, wi))
    pdf = prim_pdf / jnp.maximum(area, 1e-20) * dist2 / jnp.maximum(cos_theta, 1e-20)
    pdf = pdf * light_choice_pdf
    ro = offset_ray_origin(pn_p, face_forward(pn_n, wi))
    valid = jnp.isfinite(pdf) & (dist2 > 0.0)
    return LightSample(
        li=li,
        pdf=pdf,
        wi=wi,
        shadow_ro=ro,
        shadow_dist=dist * (1.0 - 1e-3),
        dest_tri=tri,
        n=n_light,
        tri_id=tri,
        bary=bary,
        valid=valid,
    )


def pdf_direct(lights: LightArrays, light, prim_pdf, area, ng, p_light, pn_p):
    """Solid-angle pdf of having sampled the hit light triangle toward pn
    (area.rs:108-130 x light-choice pdf, mod.rs:133-147).

    `light`/`prim_pdf` come prefetched from the surface interaction."""
    choice_pdf = jnp.where(light >= 0, lights.sel_pdf[jnp.maximum(light, 0)], 0.0)
    wi = p_light - pn_p
    dist2 = length_squared(wi)
    wi = wi / jnp.sqrt(jnp.maximum(dist2, 1e-30))[..., None]
    pdf = prim_pdf / jnp.maximum(area, 1e-20) * dist2 / jnp.maximum(jnp.abs(dot(ng, wi)), 1e-6)
    return pdf * choice_pdf
