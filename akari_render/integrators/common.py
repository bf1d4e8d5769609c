"""Shared path-tracing core used by pt / gpt / mcmc / aov.

Wavefront redesign of the reference's megakernel PathTracerBase
(crates/akari_integrator/src/pt.rs:94-901): instead of one GPU thread per
pixel running a divergent loop, a whole batch of N lanes steps through the
bounce loop together as array operations; dead lanes are masked. The bounce body is traced ONCE
and driven by `lax.fori_loop` (compile time O(1) in max_depth); an unrolled
mode exists for integrators that need per-depth taps (GPT).

Per-bounce sample consumption matches pt.rs exactly (camera 2D; per bounce:
3D light + 3D bsdf + 1D RR) so sample-replay integrators (MCMC, GPT) can
reuse this core with a replayed sampler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.math import RAY_TMAX, dot, face_forward, offset_ray_origin
from ..core.sampling import mis_weight
from ..lights import finish_light_sample, pdf_direct, sample_light_point
from ..scene import Scene


@dataclass
class PTSettings:
    max_depth: int = 7
    rr_depth: int = 5
    use_nee: bool = True
    indirect_only: bool = False
    force_diffuse: bool = False
    clamp_indirect: float = 1000.0
    color: str = "rgb"  # "rgb" | "spectral" (hero-wavelength transport)


def _select_by_kind(scene: Scene, si, fn, force_diffuse: bool = False,
                    lambda0=None):
    """Evaluate fn(closure) for each shader kind, blend by kind mask.

    The lax.switch-free analog of dispatch_surface (eval.rs:444-466):
    with K kinds all lanes evaluate all K closures and mask-select. K is
    small after bytecode dedup; the hot shade dispatch uses the sorted
    wavefront path instead (dispatch_shade below).

    force_diffuse replaces every material with Lambert 0.8 (the debugging
    mode of pt.rs:268-280)."""
    if force_diffuse:
        from ..core.sampling import INV_PI
        from ..svm.eval import SurfaceClosure
        from ..svm.surface import DiffuseBsdf

        refl = jnp.full(si["ng"].shape, 0.8 * INV_PI)
        closure = SurfaceClosure(DiffuseBsdf(refl), si["frame"], si["ng"])
        return fn(closure)
    out = None
    for mask, closure in scene.dispatch_closures(si, lambda0=lambda0):
        res = fn(closure)
        out = res if out is None else _tree_select(mask, res, out)
    return out


# ---- material-sorted wavefront shade dispatch --------------------------------
# The reference's own unfinished blueprint: KernelWorkQueue count-then-allocate
# material sorting (crates/akari_integrator/src/wfpt.rs:100-225). Array
# form: scatter lanes into kind-contiguous regions padded to a chunk multiple,
# then lax.map over chunks with a real lax.switch per chunk — each chunk is
# homogeneous in kind, so every lane evaluates exactly ONE closure instead of
# all K (the masked path pays xK). Cost: one scatter + one gather of the shade
# inputs/outputs per bounce; win: (K-1)x less shader-graph + BSDF work.

# AKR_COMPACT_NEE is a TRACE-TIME choice: it selects which graph gets
# compiled, so it is read ONCE at import (an os.environ read at
# trace time silently kept the old graph alive in jit caches when the env
# var changed mid-process; tests that flip it must reload this module or
# jax.clear_caches()).
import os as _os_mod

_COMPACT_NEE = _os_mod.environ.get("AKR_COMPACT_NEE", "1") != "0"


def _sort_dispatch_mode() -> str:
    import os

    return os.environ.get("AKR_SORT_DISPATCH", "1")


def _fuse_rays_mode() -> bool:
    """AKR_FUSE_RAYS=1: pipeline shadow + next-bounce rays into one
    traversal call per bounce (opt-in; no measured win recorded)."""
    import os

    return os.environ.get("AKR_FUSE_RAYS", "0") == "1"


def _pick_chunk(n: int, k: int) -> int:
    """Chunk size: large enough to fill the device per switch branch, small
    enough that the ~K*C/2 expected pad waste stays a minor fraction of n."""
    import os

    env = os.environ.get("AKR_SORT_CHUNK")
    if env:
        return int(env)
    c = 1 << max(10, (n // (4 * k)).bit_length() - 1)
    return max(256, min(c, 32768))


def dispatch_shade(scene: Scene, si, extra, fn, force_diffuse: bool = False):
    """Shade dispatch: fn(closure, extra) -> pytree of per-lane outputs.

    extra is a pytree of per-lane arrays fn consumes (wo, sample u's, light
    sample, ...) — passed explicitly so the sorted path can permute them
    alongside the interaction. Falls back to masked full-lane evaluation
    (x K kinds) when sorting cannot win (K == 1, tiny batches, disabled)."""
    k = len(scene.kinds)
    n = si["kind"].shape[0]
    mode = _sort_dispatch_mode()
    use_sorted = k > 1 and not force_diffuse and (
        mode == "force" or (mode != "0" and n >= 2048)
    )
    # hero wavelength for dispersive closures (spectral mode); rides extra
    # so the sorted path permutes it with the interaction
    lam0 = (extra["lambdas"][..., 0]
            if isinstance(extra, dict) and "lambdas" in extra else None)
    if not use_sorted:
        return _select_by_kind(scene, si, lambda c: fn(c, extra),
                               force_diffuse, lambda0=lam0)
    return _sorted_kind_dispatch(scene, si, extra, fn)


def _pack_f32(tree):
    """Flatten a pytree of [N]/[N,...] arrays into one [N, D] f32 matrix.

    Moving the whole shade payload as ONE row-matrix turns the sort into a
    single scatter + a single gather instead of one per operand.
    Ints are bitcast (exact); bools go through f32 0/1."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cols, specs = [], []
    for x in leaves:
        if x.dtype == jnp.bool_:
            col, tag = x.astype(jnp.float32), "b"
        elif jnp.issubdtype(x.dtype, jnp.integer):
            col, tag = (
                jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32),
                "i",
            )
        else:
            col, tag = x.astype(jnp.float32), "f"
        shape = x.shape[1:]
        col = col.reshape(col.shape[0], -1)
        specs.append((tag, shape, col.shape[1]))
        cols.append(col)
    return jnp.concatenate(cols, axis=-1), (treedef, specs)


def _unpack_f32(mat, spec):
    treedef, specs = spec
    leaves, off = [], 0
    for tag, shape, width in specs:
        col = mat[..., off : off + width].reshape(mat.shape[:-1] + shape)
        if tag == "b":
            col = col > 0.5
        elif tag == "i":
            col = jax.lax.bitcast_convert_type(col, jnp.int32)
        leaves.append(col)
        off += width
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _sorted_kind_dispatch(scene: Scene, si, extra, fn):
    """Count-then-allocate sort by shader kind + chunked lax.switch eval."""
    from ..svm.eval import dispatch_closure

    kind = si["kind"]
    n = kind.shape[0]
    k = len(scene.kinds)
    c = _pick_chunk(n, k)
    nchunks = -(-n // c) + k  # worst case: every kind region pads < one chunk
    p = nchunks * c

    # count-then-allocate (wfpt.rs CountAndAllocate mode): region offsets from
    # per-kind counts padded to chunk multiples; lane rank within its kind via
    # exclusive cumsum of the one-hot kind matrix.
    oh = jax.nn.one_hot(kind, k, dtype=jnp.int32)
    counts = jnp.sum(oh, axis=0)
    rank = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh, kind[:, None], 1)[:, 0]
    padded = ((counts + c - 1) // c) * c
    ends = jnp.cumsum(padded)
    offsets = ends - padded
    pos = offsets[kind] + rank  # unique position in [0, p)

    inp = {
        "mat": si["mat"],
        "uv": si["uv"],
        "p": si["p"],
        "ng": si["ng"],
        "frame": si["frame"],
        "extra": extra,
    }
    packed, in_spec = _pack_f32(inp)
    buf = jnp.zeros((p, packed.shape[1]), jnp.float32).at[pos].set(packed)
    chunks = buf.reshape(nchunks, c, packed.shape[1])
    # kind of the region each chunk belongs to; k (= null) past the last region
    chunk_kind = jnp.searchsorted(ends, jnp.arange(nchunks) * c, side="right")

    out_spec: list = [None]

    def make_branch(ki):
        def branch(chunk_mat):
            ch = _unpack_f32(chunk_mat, in_spec)
            csi = {"mat": ch["mat"], "uv": ch["uv"], "p": ch["p"],
                   "ng": ch["ng"], "frame": ch["frame"]}
            ex = ch["extra"]
            lam0 = (ex["lambdas"][..., 0]
                    if isinstance(ex, dict) and "lambdas" in ex else None)
            ctx = scene.eval_context(csi, ki, lambda0=lam0)
            closure = dispatch_closure(scene.kinds[ki], ctx, mode="surface")
            out, spec = _pack_f32(fn(closure, ch["extra"]))
            out_spec[0] = spec
            return out

        return branch

    branches = [make_branch(ki) for ki in range(k)]
    out_sd = jax.eval_shape(branches[0], chunks[0])
    branches.append(lambda ch: jnp.zeros(out_sd.shape, out_sd.dtype))

    def body(args):
        ck, ch = args
        return jax.lax.switch(jnp.minimum(ck, k), branches, ch)

    out_chunks = jax.lax.map(body, (chunk_kind, chunks))
    out_rows = out_chunks.reshape(p, out_sd.shape[-1])[pos]
    return _unpack_f32(out_rows, out_spec[0])


def nee_light_sample(scene: Scene, si, u_light):
    """Shared NEE front half: sample a light point and its radiance toward
    the receiver si (pt.rs:470-478, 170-209 + area.rs:83-84).

    Compact fetch (lights.attr): the light sample only needs p/ng/area/mat —
    when emission is graph-static (the common case) this skips the full
    41-column surface_interaction + shading-frame build on the light point.
    AKR_COMPACT_NEE=0 reverts; the two paths are bit-identical (same attr
    rows, same p = v0 + e1*b0 + e2*b1, same one-hot emission matmul)."""
    from ..lights import light_point_attrs, sample_light_point_ex

    a = scene.arrays
    n = si["p"].shape[0]
    compact = (
        a.lights.attr is not None
        and a.const_emission is not None
        and _COMPACT_NEE
    )
    if compact:
        light, lc_pdf, ltri, lprim_pdf, lbary, lslot = sample_light_point_ex(
            a.lights, a, u_light[..., 0], u_light[..., 1:]
        )
        lp, lng, larea, lmat = light_point_attrs(a.lights, lslot, lbary)
        ls = finish_light_sample(
            lc_pdf, lprim_pdf, ltri, lbary, jnp.zeros((n, 3)),
            lp, lng, larea, si["p"], si["ng"],
        )
        ce = a.const_emission
        oh_m = jax.nn.one_hot(lmat, ce.shape[0], dtype=jnp.float32)
        l_emission = jnp.matmul(oh_m, ce, precision=jax.lax.Precision.HIGHEST)
        front_l = dot(ls.wi, lng) < 0.0
    else:
        light, lc_pdf, ltri, lprim_pdf, lbary = sample_light_point(
            a.lights, a, u_light[..., 0], u_light[..., 1:]
        )
        lsi = scene.surface_interaction(ltri, lbary)
        ls = finish_light_sample(
            lc_pdf, lprim_pdf, ltri, lbary, jnp.zeros((n, 3)),
            lsi["p"], lsi["ng"], lsi["area"], si["p"], si["ng"],
        )
        # emission toward the receiver: direction = -wi (area.rs:83-84)
        l_emission = _emission_at(scene, lsi, -ls.wi)
        front_l = dot(ls.wi, lsi["ng"]) < 0.0
    return ls._replace(li=jnp.where(front_l[..., None], l_emission, 0.0))


def _emission_at(scene: Scene, si, wo):
    """closure.emission at an interaction — constant-folded to a one-hot
    matmul over the per-material emission table when every material's
    emission is graph-static (the common case; kills two full shader
    dispatches per bounce)."""
    ce = scene.arrays.const_emission
    if ce is not None:
        oh = jax.nn.one_hot(si["mat"], ce.shape[0], dtype=jnp.float32)
        return jnp.matmul(oh, ce, precision=jax.lax.Precision.HIGHEST)
    return _select_by_kind(scene, si, lambda c: c.emission(wo))


def _tree_select(mask, a, b):
    def sel(x, y):
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


def trace_paths(
    scene: Scene,
    settings: PTSettings,
    ray_o,
    ray_d,
    sampler,
    radiance_cb: Callable | None = None,
    unroll: bool = False,
    spectral=None,
    depth_end: int | None = None,
    resume_state: dict | None = None,
    depth_beg: int = 0,
    finalize: bool = True,
):
    """Trace one bounce-limited path per lane; returns (radiance [N,3], aux, sampler).

    sampler: pytree with next_1d/next_2d/next_3d returning (sampler, value)
    (state must be jnp arrays so it can be loop-carried).
    radiance_cb: optional hook(depth, kind, contribution, mask) — forces unroll.

    Partial tracing (the round-5 split-compacted pass, pt.py): depth_end
    bounds the bounce loop below settings.max_depth, finalize=False skips
    final_emission/clamp and returns the RAW state dict instead — the
    caller may compact its live lanes (every lane is independent, so any
    row subset resumes bit-exactly) and continue with resume_state +
    depth_beg (both static). With resume_state, ray_o/ray_d/sampler args
    are ignored (the state carries them).
    spectral: optional SampledWavelengths (lambdas/pdf [N, W]) — hero-wavelength
    spectral transport (color.rs:49-76 SampledWavelengths; the reference's
    spectral evaluation itself is todo!(), color.rs:71-73 — this implements it).
    Path decisions (BSDF sampling, RR, MIS weights) run in RGB exactly as the
    RGB mode — sample streams and kill decisions are bit-identical — while a
    parallel spectral throughput multiplies rgb2spec-uplifted factors per
    bounce and the returned radiance is the CIE-sensor estimate (XYZ->sRGB).
    RGB reflectance factors uplift via the sigmoid-polynomial table; emission
    uplifts through the normalized D65 illuminant so white emitters are D65.
    """
    a = scene.arrays
    n = (resume_state["ray_o"] if resume_state is not None else ray_o).shape[0]
    if radiance_cb is not None:
        unroll = True
    if spectral is not None and radiance_cb is not None:
        raise NotImplementedError("spectral transport with per-depth taps")
    up_table = None
    if spectral is not None:
        from ..core.spectral import (
            ensure_rgb2spec_table, eval_reflectance, illuminant_d65,
            uplift_unbounded,
        )

        up_table = ensure_rgb2spec_table()
        if up_table is None:
            raise RuntimeError(
                "spectral mode needs the rgb2spec table (native optimizer "
                "unavailable and no cached table)"
            )
        lam = spectral.lambdas  # [N, W]
        d65_at_lam = illuminant_d65(lam)

        def up_refl(rgb):
            """Reflectance-like RGB factor -> spectrum at the hero lambdas."""
            c, s = uplift_unbounded(up_table, rgb)
            return eval_reflectance(c, lam) * s[..., None]

        def up_emit(rgb):
            """Emission-like RGB factor -> spectrum (D65-shaped white)."""
            c, s = uplift_unbounded(up_table, rgb)
            return eval_reflectance(c, lam) * s[..., None] * d65_at_lam

    # fused-ray pipelining (AKR_FUSE_RAYS=1): bounce k's NEE shadow ray and
    # bounce k+1's closest-hit ray trace in ONE 2N-lane traversal call —
    # shadow rays ride as closest-hit lanes capped at the shadow distance
    # (occluded <=> a hit exists in range), and the pending NEE contribution
    # resolves one bounce later. Per-bounce fixed traversal costs (morton
    # sort, [B, K] cull, candidate-order argsort, round machinery) are paid
    # once instead of twice; sample draw order and every contribution value
    # are unchanged (only the float accumulation order moves — statistically
    # identical, A/B-tested). Opaque scenes only (alpha needs the restart
    # chains) and not under per-depth taps (GPT unrolls).
    fused = (
        _fuse_rays_mode()
        and not unroll
        and settings.use_nee
        and a.lights.num_lights > 0
        and not scene.has_alpha
    )

    if resume_state is not None:
        state = dict(resume_state)  # shallow copy; rows resume bit-exactly
    else:
        state = {
            "ray_o": ray_o,
            "ray_d": ray_d,
            "exclude": jnp.full((n,), -1, jnp.int32),
            "radiance": jnp.zeros((n, 3)),
            "beta": jnp.ones((n, 3)),
            "active": jnp.ones((n,), bool),
            "prev_bsdf_pdf": jnp.zeros((n,)),
            "base_replay": jnp.zeros((n, 3)),
            "first_albedo": jnp.zeros((n, 3)),
            "first_normal": jnp.zeros((n, 3)),
            "first_t": jnp.full((n,), RAY_TMAX),
            "sampler": sampler,
        }
        if spectral is not None:
            w_ = spectral.lambdas.shape[-1]
            state.update({
                "radiance_s": jnp.zeros((n, w_)),
                "beta_s": jnp.ones((n, w_)),
                "base_replay_s": jnp.zeros((n, w_)),
            })
            if scene.has_dispersion:
                # secondary wavelengths already terminated by a dispersive hit
                state["sec_dead"] = jnp.zeros((n,), bool)
        if fused:
            state.update({
                "p_ro": jnp.zeros((n, 3)),
                "p_wi": jnp.zeros((n, 3)),
                "p_dist": jnp.zeros((n,)),
                "p_contrib": jnp.zeros((n, 3)),
                "p_valid": jnp.zeros((n,), bool),
                "p_ex0": jnp.full((n,), -1, jnp.int32),
                "p_ex1": jnp.full((n,), -1, jnp.int32),
            })
            if spectral is not None:
                state["p_contrib_s"] = jnp.zeros((n, spectral.lambdas.shape[-1]))

    def fused_trace(st):
        """One traversal for [path rays | pending shadow rays]: returns the
        path-ray Hit and the pending lanes' occlusion booleans."""
        from ..accel.trace import Hit

        o2 = jnp.concatenate([st["ray_o"], st["p_ro"]], axis=0)
        d2 = jnp.concatenate([st["ray_d"], st["p_wi"]], axis=0)
        tmax2 = jnp.concatenate([
            jnp.where(st["active"], RAY_TMAX, -1.0),
            jnp.where(st["p_valid"], st["p_dist"], -1.0),
        ])
        ex0 = jnp.concatenate([st["exclude"], st["p_ex0"]])
        ex1 = jnp.concatenate(
            [jnp.full((n,), -1, jnp.int32), st["p_ex1"]]
        )
        hit2 = scene.intersect(
            o2, d2, jnp.zeros((2 * n,)), tmax2, exclude0=ex0, exclude1=ex1
        )
        hit = Hit(t=hit2.t[:n], tri_id=hit2.tri_id[:n],
                  bary=hit2.bary[:n], valid=hit2.valid[:n])
        return hit, hit2.valid[n:]

    def resolve_pending(st, occluded):
        ok = st["p_valid"] & ~occluded
        st["radiance"] = st["radiance"] + jnp.where(
            ok[..., None], st["p_contrib"], 0.0
        )
        if spectral is not None:
            st["radiance_s"] = st["radiance_s"] + jnp.where(
                ok[..., None], st["p_contrib_s"], 0.0
            )
        st["p_valid"] = jnp.zeros((n,), bool)
        return st

    def add_emission(st, depth, si, lane_hit, wo):
        """Surface-light hit + MIS weighting (pt.rs:230-258). depth: jnp scalar."""
        front = dot(si["ng"], st["ray_d"]) < 0.0
        ok = lane_hit & (si["light_id"] >= 0) & front
        le = _emission_at(scene, si, wo)
        if settings.use_nee:
            lpdf = pdf_direct(
                a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"], si["p"], st["ray_o"]
            )
            w = jnp.where(depth == 0, 1.0, mis_weight(st["prev_bsdf_pdf"], lpdf))
        else:
            w = jnp.ones((n,))
        if settings.indirect_only:
            w = jnp.where(depth > 1, w, 0.0)
        contrib = st["beta"] * le * w[..., None]
        st["radiance"] = st["radiance"] + jnp.where(ok[..., None], contrib, 0.0)
        if spectral is not None:
            contrib_s = st["beta_s"] * up_emit(le) * w[..., None]
            st["radiance_s"] = st["radiance_s"] + jnp.where(
                ok[..., None], contrib_s, 0.0
            )
        if radiance_cb is not None:
            radiance_cb(depth, "emission", contrib, ok)
        return st

    def bounce_body(depth, st):
        """One full bounce: intersect, Le, NEE, BSDF sample, RR, next ray."""
        depth = jnp.asarray(depth, jnp.int32)
        # dead lanes trace with tmax = -1 (already masked out; the cluster
        # cull then skips them)
        if fused:
            hit, occ_prev = fused_trace(st)
            st = resolve_pending(st, occ_prev)
        else:
            with jax.named_scope("intersect"):
                hit = scene.intersect_alpha(
                    st["ray_o"], st["ray_d"], jnp.zeros((n,)),
                    jnp.where(st["active"], RAY_TMAX, -1.0),
                    exclude0=st["exclude"],
                )
        lane_hit = st["active"] & hit.valid
        st["active"] = lane_hit
        with jax.named_scope("surface_interaction"):
            si = scene.surface_interaction(jnp.maximum(hit.tri_id, 0), hit.bary)
        wo = -st["ray_d"]

        first_mask = (depth == 0) & lane_hit
        st["first_normal"] = jnp.where(first_mask[..., None], si["ng"], st["first_normal"])
        st["first_t"] = jnp.where(first_mask, hit.t, st["first_t"])

        st = add_emission(st, depth, si, lane_hit, wo)
        st["base_replay"] = jnp.where((depth == 0)[..., None], st["radiance"], st["base_replay"])
        if spectral is not None:
            st["base_replay_s"] = jnp.where(
                (depth == 0)[..., None], st["radiance_s"], st["base_replay_s"]
            )
        cur_depth = depth + 1

        # --- NEE light sampling (pt.rs:470-478, 170-209) ---
        sampler = st["sampler"]
        sampler, u_light = sampler.next_3d()
        nee = settings.use_nee and a.lights.num_lights > 0
        if nee:
            with jax.named_scope("nee_light_sample"):
                ls = nee_light_sample(scene, si, u_light)
            light_valid = ls.valid & st["active"]
            if settings.indirect_only:
                light_valid = light_valid & (cur_depth > 1)
        else:
            ls = None
            light_valid = jnp.zeros((n,), bool)

        # --- BSDF sample + direct shading in one dispatch (pt.rs:296-323) ---
        sampler, u_bsdf = sampler.next_3d()
        extra = {"wo": wo, "u_bsdf": u_bsdf}
        if ls is not None:
            extra["ls_wi"] = ls.wi
            extra["ls_li"] = ls.li
            extra["ls_pdf"] = ls.pdf
        if spectral is not None:
            extra["lambdas"] = lam  # rides the sorted-dispatch permutation

        def shade(closure, ex):
            out = {}
            if ls is not None:
                f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
                w = mis_weight(ex["ls_pdf"], pdf_l)
                wp = (w / jnp.maximum(ex["ls_pdf"], 1e-20))[..., None]
                out["direct"] = ex["ls_li"] * f_l * wp
                if spectral is not None:
                    # spectral NEE: uplift the BSDF factor and the light
                    # radiance independently (product in the spectral domain)
                    from ..core.spectral import eval_reflectance, uplift_unbounded

                    cf, sf = uplift_unbounded(up_table, f_l)
                    cl, sl = uplift_unbounded(up_table, ex["ls_li"])
                    d65l = illuminant_d65(ex["lambdas"])
                    out["direct_s"] = (
                        eval_reflectance(cf, ex["lambdas"]) * sf[..., None]
                        * eval_reflectance(cl, ex["lambdas"]) * sl[..., None]
                        * d65l * wp
                    )
            s = closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:])
            out["wi"], out["f"], out["pdf"], out["valid"] = s["wi"], s["f"], s["pdf"], s["valid"]
            if spectral is not None:
                from ..core.spectral import eval_reflectance, uplift_unbounded

                cb, sb = uplift_unbounded(up_table, s["f"])
                out["f_s"] = eval_reflectance(cb, ex["lambdas"]) * sb[..., None]
                if scene.has_dispersion:
                    # static per-kind flag -> per-lane column so it rides
                    # the sorted-dispatch permutation
                    out["disp"] = jnp.full(
                        ex["wo"].shape[:-1],
                        bool(getattr(closure, "dispersive", False)),
                    )
            out["albedo"] = closure.albedo(ex["wo"])
            return out

        with jax.named_scope("dispatch_shade"):
            sh = dispatch_shade(scene, si, extra, shade,
                                force_diffuse=settings.force_diffuse)
        if spectral is not None and scene.has_dispersion:
            # hero-wavelength dispersion: a lane interacting with a
            # dispersive glass evaluated its IOR (refraction direction,
            # Fresnel weights) at lambda0 only — the secondary wavelengths'
            # spectral factors are invalid there, so they TERMINATE: zero
            # their throughput and compensate the hero by W once (the MC
            # sensor estimate means over W, so the estimator stays
            # unbiased; pbrt's TerminateSecondary, color.rs todo!()).
            w_ = lam.shape[-1]
            hero_w = jnp.zeros((1, w_)).at[0, 0].set(float(w_))
            newly = sh["disp"] & ~st["sec_dead"]
            mult = jnp.where(newly[..., None], hero_w, 1.0)
            sh["f_s"] = sh["f_s"] * mult
            if "direct_s" in sh:
                sh["direct_s"] = sh["direct_s"] * mult
            st["sec_dead"] = st["sec_dead"] | sh["disp"]
        st["first_albedo"] = jnp.where(first_mask[..., None], sh["albedo"], st["first_albedo"])

        # --- shadow ray + add direct (pt.rs:504-513) ---
        if ls is not None and fused:
            # stash the shadow ray + contribution; the NEXT bounce's fused
            # trace resolves occlusion (final_emission flushes the last one)
            st["p_ro"] = ls.shadow_ro
            st["p_wi"] = ls.wi
            st["p_dist"] = ls.shadow_dist
            st["p_valid"] = light_valid
            st["p_contrib"] = st["beta"] * sh["direct"]
            if spectral is not None:
                st["p_contrib_s"] = st["beta_s"] * sh["direct_s"]
            st["p_ex0"] = si["tri_id"].astype(jnp.int32)
            st["p_ex1"] = ls.dest_tri
        elif ls is not None:
            with jax.named_scope("occlude"):
                occluded = scene.occlude_alpha(
                    ls.shadow_ro, ls.wi, jnp.zeros((n,)),
                    jnp.where(light_valid, ls.shadow_dist, -1.0),
                    exclude0=si["tri_id"].astype(jnp.int32),
                    exclude1=ls.dest_tri,
                )
            direct_ok = light_valid & ~occluded
            contrib = st["beta"] * sh["direct"]
            st["radiance"] = st["radiance"] + jnp.where(direct_ok[..., None], contrib, 0.0)
            if spectral is not None:
                contrib_s = st["beta_s"] * sh["direct_s"]
                st["radiance_s"] = st["radiance_s"] + jnp.where(
                    direct_ok[..., None], contrib_s, 0.0
                )
            if radiance_cb is not None:
                radiance_cb(cur_depth, "nee", contrib, direct_ok)

        # --- continue path (pt.rs:778-866) ---
        sample_ok = sh["valid"] & (sh["pdf"] > 0.0) & (jnp.min(sh["f"], -1) >= 0.0)
        st["active"] = st["active"] & sample_ok
        st["beta"] = st["beta"] * jnp.where(
            st["active"][..., None],
            sh["f"] / jnp.maximum(sh["pdf"], 1e-20)[..., None],
            1.0,
        )
        if spectral is not None:
            st["beta_s"] = st["beta_s"] * jnp.where(
                st["active"][..., None],
                sh["f_s"] / jnp.maximum(sh["pdf"], 1e-20)[..., None],
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
        if spectral is not None:
            st["beta_s"] = st["beta_s"] / jnp.maximum(cont_prob, 1e-20)[..., None]

        st["prev_bsdf_pdf"] = sh["pdf"]
        st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
        st["ray_d"] = sh["wi"]
        st["exclude"] = si["tri_id"].astype(jnp.int32)
        st["sampler"] = sampler
        return st

    def final_emission(st):
        """Last iteration: intersect + surface-light only (pt.rs depth==max_depth)."""
        depth = jnp.asarray(settings.max_depth, jnp.int32)
        if fused:
            # also flushes the last bounce's pending shadow ray
            hit, occ_prev = fused_trace(st)
            st = resolve_pending(st, occ_prev)
        else:
            hit = scene.intersect_alpha(
                st["ray_o"], st["ray_d"], jnp.zeros((n,)),
                jnp.where(st["active"], RAY_TMAX, -1.0),
                exclude0=st["exclude"],
            )
        lane_hit = st["active"] & hit.valid
        si = scene.surface_interaction(jnp.maximum(hit.tri_id, 0), hit.bary)
        first_mask = (depth == 0) & lane_hit
        st["first_normal"] = jnp.where(first_mask[..., None], si["ng"], st["first_normal"])
        st["first_t"] = jnp.where(first_mask, hit.t, st["first_t"])
        return add_emission(st, depth, si, lane_hit, -st["ray_d"])

    d_end = settings.max_depth if depth_end is None else min(
        depth_end, settings.max_depth
    )
    if unroll:
        for depth in range(depth_beg, d_end):
            state = bounce_body(depth, state)
    else:
        # while_loop instead of fori: whole bounces are skipped once every
        # lane has died (escape/RR) — on deep configs (reference max_depth 12)
        # the tail bounces usually have no live lanes
        def bounce_cond(c):
            depth, st = c
            return (depth < d_end) & jnp.any(st["active"])

        def bounce_step(c):
            depth, st = c
            return depth + 1, bounce_body(depth, st)

        _, state = jax.lax.while_loop(
            bounce_cond, bounce_step, (jnp.int32(depth_beg), state)
        )
    if not finalize:
        return state
    state = final_emission(state)

    if spectral is not None:
        # clamp in the spectral domain (same per-channel semantics), then
        # the CIE sensor estimate converts to linear sRGB for the film
        from ..core.spectral import spectral_to_rgb

        rad_s = state["radiance_s"]
        if settings.clamp_indirect > 0.0:
            ind = jnp.clip(
                rad_s - state["base_replay_s"], None, settings.clamp_indirect
            )
            rad_s = state["base_replay_s"] + ind
        radiance = spectral_to_rgb(rad_s, spectral.lambdas, spectral.pdf)
    else:
        radiance = state["radiance"]
        if settings.clamp_indirect > 0.0:
            indirect = radiance - state["base_replay"]
            indirect = jnp.clip(indirect, None, settings.clamp_indirect)
            radiance = state["base_replay"] + indirect

    aux = {
        "albedo": state["first_albedo"],
        "normal": state["first_normal"],
        "first_t": state["first_t"],
    }
    return radiance, aux, state["sampler"]
