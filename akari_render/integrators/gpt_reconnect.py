"""Reconnection shift mapping for gradient-domain PT.

Reference: the ReconnectionShiftMapping machinery woven through
crates/akari_integrator/src/pt.rs:328-900 + gpt.rs:206-349. Semantics:

- BASE path records its first "reconnectible" vertex V = x_k: the first
  bounce where dist(x_{k-1}, x_k) >= min_dist and both endpoint roughnesses
  >= min_roughness. Stored per lane: V's triangle/bary, the pdf of the
  base's direction at x_{k-1} (the connection segment), the base's sampled
  direction + pdf AT V, the NEE sample at V (li/pdf, wi, light pdf), and
  `indirect` = radiance gathered after V at unit throughput (the
  reconnect_beta/reconnect_radiance accumulators, pt.rs:151-156, 794-822).
- SHIFT paths replay the same primary samples from the offset pixel up to
  vertex index k-1, then RECONNECT deterministically to V:
  wi' = normalize(V - x'_{k-1}); jacobian J = (cos at V toward x') /
  (cos at V toward x) * dist^2 / dist'^2; the tail reuses the BASE pdfs
  (the shift is a deterministic map of the base sample):
     contrib = beta'_{k-1} * f'(wo', wi') / pdf_base(x_{k-1}) * J *
               [ Le(V->x') * mis + f_V(wo'_V, wi_nee) * (li*mis'/pdf_l)
                 + f_V(wo'_V, wi_base)/pdf_V * indirect ]
- The shift FAILS (success=False; the base keeps pair weight 1) if it dies
  early, its own first eligible pair index is earlier than k
  (non-reversibility, pt.rs:823-829), the connection violates the
  distance/roughness criteria, or V is occluded from x'_{k-1}.
- SPECULAR / near-specular PREFIX vertices are handled exactly like the
  reference: the shifted path replays the base's sampler through them
  (gpt.rs:141-351 clones the sampler for each shift). Under VNDF GGX
  sampling, replaying the same u at the offset geometry reproduces the same
  visible-normal quantile — i.e. the half-vector copy of the hybrid shift —
  and the reconnection jacobian's pdf ratios (pdf_y1/pdf_x1 * pdf_y2/pdf_x2,
  pt.rs:683-694) supply the endpoint density correction.

Everything is lane-parallel; masks replace the reference's device control
flow, and both traces run as lax.while_loop over bounces (one bounce-body
instance in the compiled graph — the unrolled form compiled minutes per
configuration on cluster-tier scenes) with all-lanes-dead early exit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import RAY_TMAX, dot, face_forward, length, offset_ray_origin
from ..core.sampling import mis_weight
from ..lights import pdf_direct
from .common import PTSettings, _emission_at, dispatch_shade, nee_light_sample


class ReconnectionRecord(NamedTuple):
    valid: jnp.ndarray
    depth: jnp.ndarray  # [N] int32: index k of V (>= 1)
    tri: jnp.ndarray
    bary: jnp.ndarray
    prev_pdf: jnp.ndarray  # [N] base pdf of the x_{k-1} -> V direction
    wi: jnp.ndarray  # [N, 3] base's sampled dir at V
    bsdf_pdf: jnp.ndarray  # [N] base pdf of wi at V
    direct: jnp.ndarray  # [N, 3] NEE li/pdf at V (0 if occluded/invalid)
    direct_wi: jnp.ndarray
    direct_light_pdf: jnp.ndarray
    indirect: jnp.ndarray  # [N, 3] radiance after V at unit throughput
    cos_at_v: jnp.ndarray  # [N] |n_V . (dir V->x_{k-1})|
    dist: jnp.ndarray  # [N] |x_{k-1} - V|


def _bounce(scene, settings, st, depth, sampler, record_mode,
            min_dist=0.03, min_rough=0.2):
    """One bounce shared by base/shift. Returns (st, sampler, pre) where
    `pre` carries the PRE-continuation quantities the reconnection needs:
    si (this bounce's interaction = x at this index), wo, beta at the
    vertex, shading result, eligibility of the (prev, here) pair."""
    n = st["ray_o"].shape[0]
    a = scene.arrays
    hit = scene.intersect_alpha(
        st["ray_o"], st["ray_d"], jnp.zeros((n,)), jnp.full((n,), RAY_TMAX),
        exclude0=st["exclude"],
    )
    lane_hit = st["active"] & hit.valid
    si = scene.surface_interaction(jnp.maximum(hit.tri_id, 0), hit.bary)
    wo = -st["ray_d"]

    # emission on hit (MIS, pt.rs:230-258)
    front = dot(si["ng"], st["ray_d"]) < 0.0
    is_light = lane_hit & (si["light_id"] >= 0) & front
    le = _emission_at(scene, si, wo)
    lpdf = pdf_direct(
        a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"], si["p"], st["ray_o"]
    )
    w_mis = jnp.where(depth == 0, 1.0, mis_weight(st["prev_bsdf_pdf"], lpdf))
    contrib = st["beta"] * le * w_mis[..., None]
    st["radiance"] = st["radiance"] + jnp.where(is_light[..., None], contrib, 0.0)
    # depth-0 split (reference base_replay_throughput, pt.rs:415-417): the
    # camera vertex's own contributions pair at weight 1/2 in the
    # separate-weights gradient (gpt.rs:192-204) — they are pure PSS-replay
    # shifts with jacobian 1, so weighting them by the reconnection jacobian
    # (the lumped default) injects noise proportional to the DIRECT-lighting
    # magnitude (the round-4 "pss beats reconnect" measurement).
    st["radiance0"] = st["radiance0"] + jnp.where(
        (is_light & (depth == 0))[..., None], contrib, 0.0
    )
    if record_mode:
        rcontrib = st["rbeta"] * le * w_mis[..., None]
        st["rradiance"] = st["rradiance"] + jnp.where(
            (is_light & st["rec_valid"])[..., None], rcontrib, 0.0
        )

    st["active"] = lane_hit
    beta_at_vertex = st["beta"]
    pair_dist = length(si["p"] - st["prev_p"])

    # NEE (pt.rs:470-513) — shared front half incl. the compact light fetch
    sampler, u_light = sampler.next_3d()
    ls = nee_light_sample(scene, si, u_light)
    light_valid = ls.valid & st["active"]

    sampler, u_bsdf = sampler.next_3d()
    extra = {"wo": wo, "u_bsdf": u_bsdf, "ls_wi": ls.wi, "ls_li": ls.li,
             "ls_pdf": ls.pdf}

    def shade(closure, ex):
        out = {}
        f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
        w = mis_weight(ex["ls_pdf"], pdf_l)
        out["direct"] = (
            ex["ls_li"] * f_l * (w / jnp.maximum(ex["ls_pdf"], 1e-20))[..., None]
        )
        s = closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:])
        out["wi"], out["f"], out["pdf"], out["valid"] = s["wi"], s["f"], s["pdf"], s["valid"]
        out["roughness"] = closure.roughness(ex["wo"], ex["u_bsdf"][..., 0])
        return out

    # material-sorted wavefront dispatch (common.py): each lane evaluates ONE
    # kind instead of all K — GPT traces ~6 paths/pixel, so its shade bill is
    # the one most worth sorting
    sh = dispatch_shade(scene, si, extra, shade)

    occluded = scene.occlude_alpha(
        ls.shadow_ro, ls.wi, jnp.zeros((n,)), ls.shadow_dist,
        exclude0=si["tri_id"].astype(jnp.int32), exclude1=ls.dest_tri,
    )
    direct_ok = light_valid & ~occluded
    st["radiance"] = st["radiance"] + jnp.where(
        direct_ok[..., None], st["beta"] * sh["direct"], 0.0
    )
    st["radiance0"] = st["radiance0"] + jnp.where(
        (direct_ok & (depth == 0))[..., None], st["beta"] * sh["direct"], 0.0
    )
    if record_mode:
        st["rradiance"] = st["rradiance"] + jnp.where(
            (direct_ok & st["rec_valid"])[..., None], st["rbeta"] * sh["direct"], 0.0
        )

    eligible = (
        st["active"]
        & (depth >= 1)
        & (pair_dist >= min_dist)
        & (st["prev_roughness"] >= min_rough)
        & (sh["roughness"] >= min_rough)
    )

    pre = {
        "si": si, "wo": wo, "beta": beta_at_vertex, "sh": sh,
        "eligible": eligible, "pair_dist": pair_dist, "hit_valid": lane_hit,
        "ls": ls, "direct_ok": direct_ok, "prev_pdf": st["prev_bsdf_pdf"],
    }

    if record_mode:
        new_rec = eligible & ~st["rec_valid"]
        m = new_rec
        st["rec_valid"] = st["rec_valid"] | new_rec
        st["rec_depth"] = jnp.where(m, depth, st["rec_depth"])
        st["rec_tri"] = jnp.where(m, si["tri_id"].astype(jnp.int32), st["rec_tri"])
        st["rec_bary"] = jnp.where(m[..., None], hit.bary, st["rec_bary"])
        st["rec_prev_pdf"] = jnp.where(m, st["prev_bsdf_pdf"], st["rec_prev_pdf"])
        st["rec_wi"] = jnp.where(m[..., None], sh["wi"], st["rec_wi"])
        st["rec_bsdf_pdf"] = jnp.where(m, sh["pdf"], st["rec_bsdf_pdf"])
        st["rec_direct"] = jnp.where(
            (m & direct_ok)[..., None],
            ls.li / jnp.maximum(ls.pdf, 1e-20)[..., None],
            jnp.where(m[..., None], 0.0, st["rec_direct"]),
        )
        st["rec_direct_wi"] = jnp.where(m[..., None], ls.wi, st["rec_direct_wi"])
        st["rec_direct_light_pdf"] = jnp.where(m, ls.pdf, st["rec_direct_light_pdf"])
        st["rec_cos"] = jnp.where(m, jnp.abs(dot(si["ng"], wo)), st["rec_cos"])
        st["rec_dist"] = jnp.where(m, pair_dist, st["rec_dist"])
        st["rbeta"] = jnp.where(m[..., None], 1.0, st["rbeta"])
        st["rradiance"] = jnp.where(m[..., None], 0.0, st["rradiance"])
    else:
        first_el = eligible & (st["first_eligible"] < 0)
        st["first_eligible"] = jnp.where(first_el, depth, st["first_eligible"])

    # continuation
    sample_ok = sh["valid"] & (sh["pdf"] > 0.0) & (jnp.min(sh["f"], -1) >= 0.0)
    st["active"] = st["active"] & sample_ok
    throughput = sh["f"] / jnp.maximum(sh["pdf"], 1e-20)[..., None]
    st["beta"] = st["beta"] * jnp.where(st["active"][..., None], throughput, 1.0)
    if record_mode:
        just_rec = st["rec_valid"] & (st["rec_depth"] == depth)
        st["rbeta"] = st["rbeta"] * jnp.where(
            (st["active"] & st["rec_valid"] & ~just_rec)[..., None], throughput, 1.0
        )

    sampler, u_rr = sampler.next_1d()
    cont_prob = jnp.where(
        depth + 1 > settings.rr_depth,
        jnp.clip(jnp.max(st["beta"], -1), 0.0, 1.0) * 0.95,
        1.0,
    )
    st["active"] = st["active"] & (u_rr < cont_prob)
    st["beta"] = st["beta"] / jnp.maximum(cont_prob, 1e-20)[..., None]
    if record_mode:
        st["rbeta"] = st["rbeta"] / jnp.maximum(cont_prob, 1e-20)[..., None]

    st["prev_bsdf_pdf"] = sh["pdf"]
    st["prev_p"] = si["p"]
    st["prev_roughness"] = sh["roughness"]
    st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
    st["ray_d"] = sh["wi"]
    st["exclude"] = si["tri_id"].astype(jnp.int32)
    return st, sampler, pre


def _init_state(n, record_mode):
    st = {
        "exclude": jnp.full((n,), -1, jnp.int32),
        "radiance": jnp.zeros((n, 3)),
        "radiance0": jnp.zeros((n, 3)),
        "beta": jnp.ones((n, 3)),
        "active": jnp.ones((n,), bool),
        "prev_bsdf_pdf": jnp.zeros((n,)),
        "prev_p": jnp.full((n, 3), 1e10),
        "prev_roughness": jnp.zeros((n,)),
    }
    if record_mode:
        st.update(
            rec_valid=jnp.zeros((n,), bool),
            rec_depth=jnp.full((n,), -1, jnp.int32),
            rec_tri=jnp.full((n,), -1, jnp.int32),
            rec_bary=jnp.zeros((n, 2)),
            rec_prev_pdf=jnp.zeros((n,)),
            rec_wi=jnp.zeros((n, 3)),
            rec_bsdf_pdf=jnp.zeros((n,)),
            rec_direct=jnp.zeros((n, 3)),
            rec_direct_wi=jnp.zeros((n, 3)),
            rec_direct_light_pdf=jnp.zeros((n,)),
            rec_cos=jnp.zeros((n,)),
            rec_dist=jnp.zeros((n,)),
            rbeta=jnp.ones((n, 3)),
            rradiance=jnp.zeros((n, 3)),
        )
    else:
        st.update(
            first_eligible=jnp.full((n,), -1, jnp.int32),
            connected=jnp.zeros((n,), bool),
        )
    return st


def trace_base_record(scene, settings: PTSettings, ray_o, ray_d, sampler,
                      min_dist=0.03, min_rough=0.2):
    """Base path; returns (radiance, ReconnectionRecord, sampler).

    lax.while_loop rather than a Python unroll: ONE bounce-body instance in
    the compiled graph instead of max_depth copies (each carrying its own
    full traversal subgraph — the unrolled form took minutes of XLA compile
    per configuration on cluster-tier scenes), with the same all-lanes-dead
    early exit as trace_paths."""
    import jax

    n = ray_o.shape[0]
    st = _init_state(n, record_mode=True)
    st["ray_o"], st["ray_d"] = ray_o, ray_d

    def cond(c):
        depth, st, _ = c
        return (depth < settings.max_depth) & jnp.any(st["active"])

    def body(c):
        depth, st, sampler = c
        st, sampler, _ = _bounce(
            scene, settings, st, depth, sampler, True,
            min_dist=min_dist, min_rough=min_rough,
        )
        return depth + 1, st, sampler

    _, st, sampler = jax.lax.while_loop(cond, body, (jnp.int32(0), st, sampler))
    rec = ReconnectionRecord(
        valid=st["rec_valid"], depth=st["rec_depth"], tri=st["rec_tri"],
        bary=st["rec_bary"], prev_pdf=st["rec_prev_pdf"], wi=st["rec_wi"],
        bsdf_pdf=st["rec_bsdf_pdf"], direct=st["rec_direct"],
        direct_wi=st["rec_direct_wi"], direct_light_pdf=st["rec_direct_light_pdf"],
        indirect=st["rradiance"], cos_at_v=st["rec_cos"], dist=st["rec_dist"],
    )
    return (st["radiance"], st["radiance0"]), rec, sampler


def trace_shift_reconnect(scene, settings: PTSettings, ray_o, ray_d, sampler,
                          rec: ReconnectionRecord, min_dist=0.03, min_rough=0.2):
    """Shifted path with reconnection; returns (radiance, jacobian, success,
    sampler) — the reference weighting (pt.rs:536-775): the connection's tail
    divides by the SHIFTED path's pdfs (pdf_y1 at x'_{k-1}, pdf_y2 at V) and
    the jacobian carries the pdf ratios

        J = (pdf_y1/pdf_x1) * (pdf_y2/pdf_x2) * |cos'_V|/|cos_V| * d^2/d'^2

    so contributions that route through the base pdfs recover exactly when
    the gradient applies radiance * J. `radiance` has NO jacobian applied
    (the pairing in gpt.py applies it, gpt.rs:318-331); success=False lanes
    contribute nothing to the pair (the base keeps weight 1)."""
    import jax

    n = ray_o.shape[0]
    st = _init_state(n, record_mode=False)
    st["ray_o"], st["ray_d"] = ray_o, ray_d
    st["conn"] = jnp.zeros((n, 3))
    jacobian = jnp.zeros((n,))
    success = jnp.zeros((n,), bool)
    v_si = scene.surface_interaction(jnp.maximum(rec.tri, 0), rec.bary)

    def shift_cond(c):
        depth, st, _, _, _ = c
        return (depth < settings.max_depth) & jnp.any(st["active"])

    def shift_body(c):
        depth, st, sampler, jacobian, success = c
        st, sampler, pre = _bounce(
            scene, settings, st, depth, sampler, False,
            min_dist=min_dist, min_rough=min_rough,
        )
        si = pre["si"]
        do_connect = (
            rec.valid
            & pre["hit_valid"]
            & ~st["connected"]
            & (depth == rec.depth - 1)
            & ((st["first_eligible"] < 0) | (st["first_eligible"] >= rec.depth))
        )
        xp = si["p"]
        to_v = v_si["p"] - xp
        dist_p = length(to_v)
        wi_p = to_v / jnp.maximum(dist_p, 1e-20)[..., None]
        ok = (
            do_connect
            & (dist_p >= min_dist)
            & (pre["sh"]["roughness"] >= min_rough)
        )
        ro = offset_ray_origin(xp, face_forward(si["ng"], wi_p))
        occ = scene.occlude_alpha(
            ro, wi_p, jnp.zeros((n,)), dist_p * (1.0 - 1e-3),
            exclude0=si["tri_id"].astype(jnp.int32), exclude1=rec.tri,
        )
        ok = ok & ~occ

        # f1, pdf_y1 at x'_{k-1} (the shifted connection segment)
        wo_p = pre["wo"]

        def eval_conn(closure, ex):
            f, pdf = closure.evaluate(ex["wo"], ex["wi"])
            return {"f": f, "pdf": pdf}

        cv = dispatch_shade(scene, si, {"wo": wo_p, "wi": wi_p}, eval_conn)
        f1, pdf_y1 = cv["f"], cv["pdf"]

        # V-side with wo'_V = -wi': NEE re-eval (fd, pd) and the base exit
        # direction re-eval (f2, pdf_y2)
        wo_v = -wi_p

        def eval_v(closure, ex):
            fd, pd = closure.evaluate(ex["wo"], ex["dwi"])
            f2, pdf_y2 = closure.evaluate(ex["wo"], ex["wi"])
            return {"fd": fd, "pd": pd, "f2": f2, "pdf_y2": pdf_y2}

        vv = dispatch_shade(
            scene, v_si, {"wo": wo_v, "dwi": rec.direct_wi, "wi": rec.wi}, eval_v
        )
        le_v = _emission_at(scene, v_si, wo_v)
        front_v = (dot(v_si["ng"], wi_p) < 0.0) & (v_si["light_id"] >= 0)
        lpdf_v = pdf_direct(
            scene.arrays.lights, v_si["light_id"], v_si["prim_pdf"],
            v_si["area"], v_si["ng"], v_si["p"], xp,
        )
        # MIS against NEE from the SHIFTED prefix vertex (pt.rs:723-726)
        w_le = mis_weight(pdf_y1, lpdf_v)
        le_term = jnp.where(front_v[..., None], le_v * w_le[..., None], 0.0)
        w_nee = mis_weight(rec.direct_light_pdf, vv["pd"])
        nee_term = vv["fd"] * rec.direct * w_nee[..., None]
        ind_term = jnp.where(
            (vv["pdf_y2"] > 0.0)[..., None],
            vv["f2"] / jnp.maximum(vv["pdf_y2"], 1e-20)[..., None] * rec.indirect,
            0.0,
        )
        tail = le_term + nee_term + ind_term

        # RR continue probability as if the shifted path continued through
        # the connection (pt.rs:737-741) — mirrors the base's cont_prob form
        f_pdf = f1 / jnp.maximum(pdf_y1, 1e-20)[..., None]
        beta_conn = pre["beta"] * f_pdf
        cont_prob = jnp.where(
            rec.depth > settings.rr_depth,
            jnp.clip(jnp.max(beta_conn, -1), 0.0, 1.0) * 0.95,
            1.0,
        )
        conn = beta_conn * tail / jnp.maximum(cont_prob, 1e-20)[..., None]

        # jacobian with pdf ratios (pt.rs:683-694, 762-765)
        def ratio(py, px):
            return jnp.where(
                px <= 0.0, jnp.where(py <= 0.0, 1.0, 0.0), py / jnp.maximum(px, 1e-20)
            )

        pdf_ratio = ratio(pdf_y1, rec.prev_pdf) * ratio(vv["pdf_y2"], rec.bsdf_pdf)
        cos_p = jnp.abs(dot(v_si["ng"], wo_v))
        J = (
            pdf_ratio
            * (cos_p / jnp.maximum(rec.cos_at_v, 1e-20))
            * (rec.dist**2 / jnp.maximum(dist_p**2, 1e-20))
        )
        J = jnp.where(jnp.isfinite(J), J, 0.0)
        ok = ok & (J > 0.0)

        st["conn"] = st["conn"] + jnp.where(ok[..., None], conn, 0.0)
        jacobian = jnp.where(ok, J, jacobian)
        success = success | ok
        st["connected"] = st["connected"] | ok
        # connecting lanes (even failed ones at their index) stop replaying
        st["active"] = st["active"] & ~do_connect
        return depth + 1, st, sampler, jacobian, success

    _, st, sampler, jacobian, success = jax.lax.while_loop(
        shift_cond, shift_body, (jnp.int32(0), st, sampler, jacobian, success)
    )
    # No-vertex fallback (reference pt.rs end-of-trace: with no valid
    # reconnection vertex the shift ran as a FULL PSS replay and counts as a
    # successful jacobian-1 shift unless its own replay found an eligible
    # pair — the reverse map would have reconnected there, so the replay is
    # not the inverse). The previous formulation failed these lanes to
    # `-base`, discarding all replay correlation for specular/short paths.
    fallback_ok = ~rec.valid & (st["first_eligible"] < 0)
    success = success | fallback_ok
    jacobian = jnp.where(fallback_ok, 1.0, jacobian)
    # radiance split: (replay depth-0 part, everything-else part incl. the
    # reconnection term) — the separate-weights gradient (gpt.rs:321-327)
    # pairs the first at weight 1/2 and the second under jacobian MIS.
    rest = st["radiance"] - st["radiance0"] + st["conn"]
    return (st["radiance0"], rest), jacobian, success, sampler
