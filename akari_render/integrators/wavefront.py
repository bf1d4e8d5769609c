"""Persistent wavefront path tracing: stream compaction + queue refill.

The pass-based core (common.trace_paths) carries a fixed N-lane batch from
depth 0 to max_depth; lanes that die early (escape / RR — the majority past
depth ~5 of 12) still occupy traversal blocks and shade chunks until every
lane dies. This module keeps the wavefront FULL instead: one persistent pool
of lanes at mixed depths, and after every bounce the dead lanes are retired
(their radiance scatter-added into the film) and immediately refilled with
fresh camera samples pulled from the pass's (pixel, sample) work queue.

This finishes the reference's own wavefront blueprint — fixed-capacity SoA
queues with count-then-allocate compaction (crates/akari_integrator/src/
wfpt.rs:45-73, 100-225) — in array form: the "queue" is an integer
range (item = sample * npix + pixel, so refilled lanes are spatially
coherent), compaction is a cumsum rank over the dead mask, and the film's
f32 atomics are jnp scatter-adds.

Per-item radiance is IDENTICAL to the pass-based path (same sampler stream
keyed by (pixel, sample), same bounce math — depth simply lives per-lane
instead of per-loop); only the film accumulation order differs, so an A/B
against render_pt converges to allclose, which tests/test_wavefront.py
asserts.

One device dispatch runs at most AKR_WF_ITERS bounce iterations
(lax.while_loop with an iteration cap, early exit when the queue drains and
every lane has died); the host loop re-dispatches with donated carries
until done.
"""
from __future__ import annotations

import time
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import generate_rays
from ..config import PTConfig
from ..core.film import Film, develop
from ..core.filters import filter_from_config
from ..core.math import RAY_TMAX, dot, face_forward, offset_ray_origin
from ..core.sampling import mis_weight
from ..lights import pdf_direct
from ..scene import Scene
from .common import PTSettings, _emission_at, dispatch_shade, nee_light_sample
from .pt import max_wavefront_lanes


def _fresh_lanes(scene: Scene, filt, width, height, item, sampler_config,
                 seed, fused=False, npix_owned=None, pix_base=None):
    """Build lane state for queue items (item = sample * npix_owned + local
    pixel). `lanes["pix"]` stores the LOCAL index (the film scatter target);
    the sampler stream and raster position use the GLOBAL pixel
    `pix_base + local` so a sharded render reproduces the single-chip
    (pixel, sample)-keyed streams exactly."""
    from ..core.lds import make_sampler

    npix_owned = width * height if npix_owned is None else npix_owned
    n = item.shape[0]
    sample_idx = (item // npix_owned).astype(jnp.uint32)
    local = (item % npix_owned).astype(jnp.uint32)
    pix = local if pix_base is None else local + pix_base
    sampler = make_sampler(sampler_config, pix, sample_idx, seed)
    sampler, u_film = sampler.next_2d()
    off, fw = filt.sample(u_film)
    p_film = (
        jnp.stack(
            [(pix % width).astype(jnp.float32), (pix // width).astype(jnp.float32)],
            -1,
        )
        + 0.5
        + off
    )
    ray_o, ray_d = generate_rays(scene.camera, p_film)
    lanes = {
        "pix": local.astype(jnp.int32),
        "fw": fw,
        "ray_o": ray_o,
        "ray_d": ray_d,
        "exclude": jnp.full((n,), -1, jnp.int32),
        "radiance": jnp.zeros((n, 3)),
        "beta": jnp.ones((n, 3)),
        "active": jnp.ones((n,), bool),
        "prev_bsdf_pdf": jnp.zeros((n,)),
        "base_replay": jnp.zeros((n, 3)),
        "depth": jnp.zeros((n,), jnp.int32),
        "sampler": sampler,
    }
    if fused:  # pending NEE shadow ray (resolved by the NEXT bounce's trace)
        lanes.update({
            "p_ro": jnp.zeros((n, 3)),
            "p_wi": jnp.zeros((n, 3)),
            "p_dist": jnp.zeros((n,)),
            "p_contrib": jnp.zeros((n, 3)),
            "p_valid": jnp.zeros((n,), bool),
            "p_ex0": jnp.full((n,), -1, jnp.int32),
            "p_ex1": jnp.full((n,), -1, jnp.int32),
        })
    return lanes


def _lane_select(mask, a, b):
    """_tree_select that passes LANE-INDEPENDENT leaves through: the pmj02
    sampler pytree carries a shared [S*N, 2] sample-table leaf that is
    identical in every lane state (same make_sampler config), so masking it
    per-lane is both a shape error and pointless — any leaf whose leading
    dim is not the lane count is returned as-is."""
    n = mask.shape[0]

    def sel(x, y):
        if x.ndim == 0 or x.shape[0] != n:
            return x
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


def _resolve_pending(st, occluded):
    """Fused mode: land the previous bounce's NEE contribution."""
    ok = st["p_valid"] & ~occluded
    st["radiance"] = st["radiance"] + jnp.where(
        ok[..., None], st["p_contrib"], 0.0
    )
    st["p_valid"] = jnp.zeros_like(st["p_valid"])
    return st


def _bounce_perlane(scene: Scene, settings: PTSettings, st, fused=False):
    """One bounce at per-lane depth — the same math as common.trace_paths'
    bounce_body + final_emission folded together: a lane whose depth has
    reached max_depth takes the emission tap and dies (pt.rs depth==max
    final intersect), everyone else continues through NEE/BSDF/RR.

    fused: the previous bounce's pending shadow rays ride in the SAME
    traversal as this bounce's closest-hit rays (per-lane any-hit lanes; see
    common.trace_paths fused mode) and their contribution lands here."""
    a = scene.arrays
    n = st["pix"].shape[0]
    depth = st["depth"]

    if fused:
        from ..accel.trace import Hit

        o2 = jnp.concatenate([st["ray_o"], st["p_ro"]], axis=0)
        d2 = jnp.concatenate([st["ray_d"], st["p_wi"]], axis=0)
        tmax2 = jnp.concatenate([
            jnp.where(st["active"], RAY_TMAX, -1.0),
            jnp.where(st["p_valid"], st["p_dist"], -1.0),
        ])
        ex0 = jnp.concatenate([st["exclude"], st["p_ex0"]])
        ex1 = jnp.concatenate([jnp.full((n,), -1, jnp.int32), st["p_ex1"]])
        hit2 = scene.intersect(
            o2, d2, jnp.zeros((2 * n,)), tmax2, exclude0=ex0, exclude1=ex1
        )
        hit = Hit(t=hit2.t[:n], tri_id=hit2.tri_id[:n],
                  bary=hit2.bary[:n], valid=hit2.valid[:n])
        st = _resolve_pending(st, hit2.valid[n:])
    else:
        hit = scene.intersect_alpha(
            st["ray_o"], st["ray_d"], jnp.zeros((n,)),
            jnp.where(st["active"], RAY_TMAX, -1.0),
            exclude0=st["exclude"],
        )
    lane_hit = st["active"] & hit.valid
    si = scene.surface_interaction(jnp.maximum(hit.tri_id, 0), hit.bary)
    wo = -st["ray_d"]

    # surface-light emission + MIS (pt.rs:230-258)
    front = dot(si["ng"], st["ray_d"]) < 0.0
    ok = lane_hit & (si["light_id"] >= 0) & front
    le = _emission_at(scene, si, wo)
    if settings.use_nee:
        lpdf = pdf_direct(
            a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"],
            si["p"], st["ray_o"],
        )
        w = jnp.where(depth == 0, 1.0, mis_weight(st["prev_bsdf_pdf"], lpdf))
    else:
        w = jnp.ones((n,))
    if settings.indirect_only:
        w = jnp.where(depth > 1, w, 0.0)
    st["radiance"] = st["radiance"] + jnp.where(
        ok[..., None], st["beta"] * le * w[..., None], 0.0
    )
    st["base_replay"] = jnp.where(
        (depth == 0)[..., None], st["radiance"], st["base_replay"]
    )

    # lanes at the depth limit stop here (final emission tap only)
    st["active"] = lane_hit & (depth < settings.max_depth)
    cur_depth = depth + 1

    # NEE light sampling (pt.rs:470-478, 170-209)
    sampler = st["sampler"]
    sampler, u_light = sampler.next_3d()
    nee = settings.use_nee and a.lights.num_lights > 0
    if nee:
        ls = nee_light_sample(scene, si, u_light)
        light_valid = ls.valid & st["active"]
        if settings.indirect_only:
            light_valid = light_valid & (cur_depth > 1)
    else:
        ls = None
        light_valid = jnp.zeros((n,), bool)

    # BSDF sample + direct shading in one dispatch (pt.rs:296-323)
    sampler, u_bsdf = sampler.next_3d()
    extra = {"wo": wo, "u_bsdf": u_bsdf}
    if ls is not None:
        extra["ls_wi"] = ls.wi
        extra["ls_li"] = ls.li
        extra["ls_pdf"] = ls.pdf

    def shade(closure, ex):
        out = {}
        if ls is not None:
            f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
            w = mis_weight(ex["ls_pdf"], pdf_l)
            out["direct"] = (
                ex["ls_li"] * f_l * (w / jnp.maximum(ex["ls_pdf"], 1e-20))[..., None]
            )
        s = closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:])
        out["wi"], out["f"], out["pdf"], out["valid"] = (
            s["wi"], s["f"], s["pdf"], s["valid"],
        )
        return out

    sh = dispatch_shade(scene, si, extra, shade, force_diffuse=settings.force_diffuse)

    # shadow ray + add direct (pt.rs:504-513)
    if ls is not None and fused:
        st["p_ro"] = ls.shadow_ro
        st["p_wi"] = ls.wi
        st["p_dist"] = ls.shadow_dist
        st["p_valid"] = light_valid
        st["p_contrib"] = st["beta"] * sh["direct"]
        st["p_ex0"] = si["tri_id"].astype(jnp.int32)
        st["p_ex1"] = ls.dest_tri
    elif ls is not None:
        occluded = scene.occlude_alpha(
            ls.shadow_ro, ls.wi, jnp.zeros((n,)),
            jnp.where(light_valid, ls.shadow_dist, -1.0),
            exclude0=si["tri_id"].astype(jnp.int32), exclude1=ls.dest_tri,
        )
        direct_ok = light_valid & ~occluded
        st["radiance"] = st["radiance"] + jnp.where(
            direct_ok[..., None], st["beta"] * sh["direct"], 0.0
        )

    # continue path (pt.rs:778-866)
    sample_ok = sh["valid"] & (sh["pdf"] > 0.0) & (jnp.min(sh["f"], -1) >= 0.0)
    st["active"] = st["active"] & sample_ok
    st["beta"] = st["beta"] * jnp.where(
        st["active"][..., None],
        sh["f"] / jnp.maximum(sh["pdf"], 1e-20)[..., None],
        1.0,
    )

    # russian roulette (pt.rs:210-224, 843-850)
    sampler, u_rr = sampler.next_1d()
    cont_prob = jnp.where(
        cur_depth > settings.rr_depth,
        jnp.clip(jnp.max(st["beta"], -1), 0.0, 1.0) * 0.95,
        1.0,
    )
    st["active"] = st["active"] & (u_rr < cont_prob)
    st["beta"] = st["beta"] / jnp.maximum(cont_prob, 1e-20)[..., None]

    st["prev_bsdf_pdf"] = sh["pdf"]
    st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
    st["ray_d"] = sh["wi"]
    st["exclude"] = si["tri_id"].astype(jnp.int32)
    st["depth"] = cur_depth
    st["sampler"] = sampler
    return st


def _finish_radiance(settings: PTSettings, st):
    """Path-end clamp (common.trace_paths tail): indirect = total - the
    directly-seen emission, clipped."""
    radiance = st["radiance"]
    if settings.clamp_indirect > 0.0:
        indirect = jnp.clip(
            radiance - st["base_replay"], None, settings.clamp_indirect
        )
        radiance = st["base_replay"] + indirect
    from ..core.film import remove_nan

    return remove_nan(radiance)


def make_step_fn(scene: Scene, settings: PTSettings, filt, width, height,
                 sampler_config, seed, fused=False, npix_owned=None):
    """The raw (unjitted) persistent step over a device-owned pixel range:
    up to `iters` retire/refill/bounce rounds. `accum`/`weight` cover the
    npix_owned LOCAL rows; queue items decode against npix_owned and
    `pix_base` shifts rays/samplers to global pixels (0 single-chip;
    axis_index * per_dev under shard_map)."""
    npix_owned = width * height if npix_owned is None else npix_owned

    def step(arrays, accum, weight, lanes, qhead, total, iters,
             pix_base=jnp.uint32(0)):
        sc = replace(scene, arrays=arrays)

        def refill(carry):
            accum, weight, lanes, qhead = carry
            done = ~lanes["active"]
            if fused:  # a pending NEE must land before the lane retires
                done = done & ~lanes["p_valid"]
            retire = done & (lanes["pix"] >= 0)
            pixc = jnp.clip(lanes["pix"], 0, npix_owned - 1)
            contrib = _finish_radiance(settings, lanes) * lanes["fw"][..., None]
            accum = accum.at[pixc].add(
                jnp.where(retire[..., None], contrib, 0.0)
            )
            weight = weight.at[pixc].add(jnp.where(retire, lanes["fw"], 0.0))
            # mark retired slots empty, then refill empties from the queue
            empty = done
            rank = jnp.cumsum(empty.astype(jnp.int32)) - empty.astype(jnp.int32)
            item = qhead + rank
            have = empty & (item < total)
            fresh = _fresh_lanes(
                sc, filt, width, height, jnp.minimum(item, total - 1),
                sampler_config, seed, fused, npix_owned, pix_base,
            )
            lanes["pix"] = jnp.where(empty, -1, lanes["pix"])
            lanes["active"] = lanes["active"] & ~empty
            lanes = _lane_select(have, fresh, lanes)
            qhead = jnp.minimum(qhead + jnp.sum(empty.astype(jnp.int32)), total)
            return accum, weight, lanes, qhead

        def cond(c):
            i, accum, weight, lanes, qhead = c
            live = jnp.any(lanes["active"])
            if fused:
                live = live | jnp.any(lanes["p_valid"])
            return (i < iters) & ((qhead < total) | live)

        def body(c):
            i, accum, weight, lanes, qhead = c
            # GATED refill: the refill step — whole-pool _fresh_lanes
            # camera+sampler rebuild, a ~25-leaf _lane_select, two
            # scatter-adds and a cumsum — costs a large fraction of a
            # bounce, so it must not run EVERY bounce. Dead lanes are merely
            # masked work for the bounce, so batching retirement until a
            # quarter of the pool is dead trades <= 25% occupancy loss for
            # ~4x fewer refills. Exact: per-lane radiance never depends on
            # WHEN a dead sibling retires, and the queue-drain/final-flush
            # logic is unchanged.
            dead = ~lanes["active"]
            if fused:
                dead = dead & ~lanes["p_valid"]
            frac_dead = jnp.mean(dead.astype(jnp.float32))
            need = (frac_dead >= 0.25) | (qhead == 0)
            accum, weight, lanes, qhead = jax.lax.cond(
                need, refill, lambda carry: carry,
                (accum, weight, lanes, qhead),
            )
            lanes = _bounce_perlane(sc, settings, lanes, fused)
            return i + 1, accum, weight, lanes, qhead

        _, accum, weight, lanes, qhead = jax.lax.while_loop(
            cond, body, (jnp.int32(0), accum, weight, lanes, qhead)
        )
        if fused:  # flush outstanding pending shadows before retiring lanes
            n = lanes["pix"].shape[0]
            occluded = sc.occlude_alpha(
                lanes["p_ro"], lanes["p_wi"], jnp.zeros((n,)),
                jnp.where(lanes["p_valid"], lanes["p_dist"], -1.0),
                exclude0=lanes["p_ex0"], exclude1=lanes["p_ex1"],
            )
            lanes = _resolve_pending(lanes, occluded)
        # flush lanes that died on the capped last bounce without waiting for
        # the next dispatch's refill (keeps the final dispatch's tail exact)
        retire = (~lanes["active"]) & (lanes["pix"] >= 0)
        pixc = jnp.clip(lanes["pix"], 0, npix_owned - 1)
        contrib = _finish_radiance(settings, lanes) * lanes["fw"][..., None]
        accum = accum.at[pixc].add(jnp.where(retire[..., None], contrib, 0.0))
        weight = weight.at[pixc].add(jnp.where(retire, lanes["fw"], 0.0))
        lanes["pix"] = jnp.where(retire, -1, lanes["pix"])
        n_active = jnp.sum(lanes["active"].astype(jnp.int32))
        return accum, weight, lanes, qhead, n_active

    return step


def _make_step(scene: Scene, settings: PTSettings, filt, width, height,
               sampler_config, seed, pool, fused=False):
    """Jitted single-chip persistent step (pix_base 0, whole-film rows)."""
    step = make_step_fn(scene, settings, filt, width, height, sampler_config,
                        seed, fused)
    return jax.jit(step, donate_argnums=(1, 2, 3), static_argnums=(6,))


_STEPS: dict = {}  # (scene id, static config) -> (jitted step, scene ref)


def _empty_lanes(scene: Scene, filt, width, height, pool, sampler_config,
                 seed, fused=False):
    lanes = _fresh_lanes(
        scene, filt, width, height, jnp.zeros((pool,), jnp.int32),
        sampler_config, seed, fused,
    )
    lanes["pix"] = jnp.full((pool,), -1, jnp.int32)
    lanes["active"] = jnp.zeros((pool,), bool)
    return lanes


def render_pt_wavefront(scene: Scene, config: PTConfig, task=None,
                        progress_cb=None, session=None):
    """Persistent-wavefront render_pt: same image distribution, full lanes.

    Returns (image [H, W, 3] numpy, stats dict) like integrators/pt.py.
    """
    width, height = scene.camera.width, scene.camera.height
    npix = width * height
    filt = filter_from_config(task.filter_config if task else None)
    settings = PTSettings(
        max_depth=config.max_depth,
        rr_depth=config.rr_depth,
        use_nee=config.use_nee,
        indirect_only=config.indirect_only,
        force_diffuse=config.force_diffuse,
        clamp_indirect=config.clamp_indirect,
    )
    seed = task.seed if task else 0
    sampler_config = task.sampler if task else None
    pool = min(npix * config.spp, max_wavefront_lanes(scene))
    from .common import _fuse_rays_mode

    fused = (
        _fuse_rays_mode()
        and settings.use_nee
        and scene.arrays.lights.num_lights > 0
        and not scene.has_alpha
    )

    # process-wide memo: repeat renders reuse the traced step (retracing the
    # bounce graph costs seconds of host time per call); the scene rides in
    # the value so its id() can't be recycled onto a live entry
    key = (id(scene), repr(settings), repr(filt), width, height,
           repr(sampler_config), seed, pool, fused)
    if key not in _STEPS:
        _STEPS[key] = (
            _make_step(scene, settings, filt, width, height, sampler_config,
                       seed, pool, fused),
            scene,
        )
    step = _STEPS[key][0]
    accum = jnp.zeros((npix, 3))
    weight = jnp.zeros((npix,))
    lanes = _empty_lanes(scene, filt, width, height, pool, sampler_config,
                         seed, fused)
    qhead = jnp.int32(0)
    total = jnp.int32(npix * config.spp)

    stats = {"time": [], "spp": []}
    t0 = time.time()

    # iterations per dispatch: drain the queue in one call unless
    # AKR_WF_ITERS asks for more frequent progress reports
    import os

    iters = int(os.environ.get("AKR_WF_ITERS", "0")) or 10 ** 9

    done_items = 0
    while True:
        accum, weight, lanes, qhead, n_active = step(
            scene.arrays, accum, weight, lanes, qhead, total, iters
        )
        qh = int(qhead)
        na = int(n_active)
        done_items = qh - na
        if progress_cb is not None:
            stats["time"].append(time.time() - t0)
            stats["spp"].append(done_items // max(npix, 1))
            progress_cb(done_items // max(npix, 1), config.spp, stats)
        if session is not None and session.display is not None:
            film = Film(accum=accum, splat=jnp.zeros_like(accum), weight=weight)
            session.display(np.asarray(develop(film, width, height)))
        if qh >= int(total) and na == 0:
            break
    jax.block_until_ready(accum)
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = config.spp
    film = Film(accum=accum, splat=jnp.zeros_like(accum), weight=weight)
    img = np.asarray(develop(film, width, height))
    return img, stats
