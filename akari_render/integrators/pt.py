"""Path tracer integrator: per-pass wavefront rendering into a Film.

Reference: crates/akari_integrator/src/pt.rs:1056-1172 (PathTracer::render —
per-pixel kernel with spp_per_pass inner loop, host pass loop with progress
and intermediate stats). Here each pass jit-traces `spp_chunk` samples for
every pixel; the host loop accumulates into the film and collects the same
stats-JSON series (time, spp) the reference emits (lib.rs:24-37).
"""
from __future__ import annotations

import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import generate_rays
from ..config import PTConfig
from ..core.film import Film, add_samples, develop
from ..core.filters import filter_from_config
from ..core.samplers import IndependentSampler
from ..scene import Scene
from .common import PTSettings, trace_paths


def max_wavefront_lanes(scene: Scene) -> int:
    """Lane cap per traced wavefront so the cluster-cull intermediates
    ([lanes, min(K, CULL_CHUNK)] f32 buffers) stay bounded: a full-frame
    dispatch of classroom 1080p (2.07M pixels) would not fit. Brute-tier
    scenes have no [N, K] intermediates. AKR_MAX_LANES overrides."""
    import os

    env = os.environ.get("AKR_MAX_LANES")
    if env:
        return max(1024, int(env))
    from ..accel.cluster import CULL_CHUNK

    k_eff = 0
    a = scene.arrays
    if a.bvh is not None:
        k_eff = max(k_eff, min(a.bvh["clusters"].num_clusters, CULL_CHUNK))
    if a.instanced is not None:
        k_eff = max(k_eff, min(int(a.instanced.clusters.cbmin.shape[0]), CULL_CHUNK))
    if k_eff == 0:
        return 1 << 22
    budget_elems = 1 << 26  # 256 MB per f32 [lanes, K] buffer
    return max(1 << 16, budget_elems // k_eff)


def _split_depth(scene: Scene, settings: PTSettings) -> int | None:
    """Split-compacted pass config: depth at which the pass compacts live
    lanes into narrow chunks. On cluster-tier scenes traversal pays per-
    dispatch costs (the [B, K] cull runs at full width even when few lanes
    live), and after the first post-RR depth the live fraction collapses
    (classroom: 99.8% live at depth 3, ~3% at depth 6 with rr_depth 5), so
    the tail depths re-dispatch at 1/AKR_SPLIT_FRAC width. Lanes are
    independent: any row subset resumes bit-exactly
    (tests/test_pipeline.py asserts equality with the unsplit pass).

    AKR_SPLIT_DEPTH=d enables at depth d, =0 disables. Default: rr_depth + 1
    on cluster-tier scenes, off on brute-tier scenes (which pay per lane,
    not per dispatch).
    """
    import os

    if settings.color == "spectral":
        # the spectral throughput state is tied to per-lane wavelengths the
        # resume path does not re-thread; keep spectral renders unsplit
        return None
    v = os.environ.get("AKR_SPLIT_DEPTH", "")
    if v:
        d = int(v)
        return d if 0 < d < settings.max_depth else None
    if (
        (scene.arrays.bvh is not None or scene.arrays.instanced is not None)
        and settings.max_depth > settings.rr_depth + 1
    ):
        return settings.rr_depth + 1
    return None


def _render_pass_fn_split(scene: Scene, settings: PTSettings, filt, width,
                          height, spp_chunk, split_d, seed=0,
                          sampler_config=None):
    """Split-compacted pass (see _split_depth): phase 1 traces depths
    [0, split_d) at full block width inside one jit and returns the raw
    path state + a live-lanes-first permutation; the host reads ONE scalar
    (the live count), then phase 2 resumes depths [split_d, max] on
    compacted chunks of pb//AKR_SPLIT_FRAC lanes — as many chunks as the
    live count needs, all hitting the same compiled graph. Lane math is
    identical to the fused pass (compaction is a pure row permutation of
    independent lanes), so the image is bit-exact vs AKR_SPLIT_DEPTH=0."""
    import os

    npix = width * height
    from ..core.film import remove_nan
    from ..core.lds import make_sampler

    pb = min(npix, max_wavefront_lanes(scene))
    n_blocks = -(-npix // pb)
    npad = n_blocks * pb
    frac = max(2, int(os.environ.get("AKR_SPLIT_FRAC", "8")))
    pc = min(pb, max(512, pb // frac))

    def phase1(arrays, sample_idx, p0):
        sc = replace(scene, arrays=arrays)
        pix = (p0 + jnp.arange(pb, dtype=jnp.int32)).astype(jnp.uint32)
        valid = pix < npix
        pixc = jnp.minimum(pix, npix - 1)
        sampler = make_sampler(
            sampler_config, pixc, sample_idx.astype(jnp.uint32), seed
        )
        sampler, u_film = sampler.next_2d()
        off, fw = filt.sample(u_film)
        p_film = jnp.stack(
            [(pixc % width).astype(jnp.float32),
             (pixc // width).astype(jnp.float32)], -1
        ) + 0.5 + off
        ray_o, ray_d = generate_rays(sc.camera, p_film)
        st = trace_paths(
            sc, settings, ray_o, ray_d, sampler,
            depth_end=split_d, finalize=False,
        )
        live = st["active"]
        perm = jnp.argsort(~live).astype(jnp.int32)  # stable: live first
        count = jnp.sum(live.astype(jnp.int32))
        return st, perm, count, jnp.where(valid, fw, 0.0)

    p1 = jax.jit(phase1)

    def phase2_chunk(arrays, st, perm, c, radiance):
        sc = replace(scene, arrays=arrays)
        ids = jax.lax.dynamic_slice(perm, (c * pc,), (pc,))
        # compact per-lane rows; pass shared leaves (e.g. a table-driven
        # sampler's sample tables, leading dim != pb) through untouched
        stc = jax.tree_util.tree_map(
            lambda x: x[ids] if (jnp.ndim(x) and x.shape[0] == pb) else x, st
        )
        rad, _aux, _s = trace_paths(
            sc, settings, None, None, None,
            resume_state=stc, depth_beg=split_d,
        )
        # rows are a permutation slice (unique ids); chunk-straddling dead
        # rows and the clamped finalize are idempotent, so a plain set is
        # exact even when the last chunk overlaps
        return radiance.at[ids].set(rad)
    # no donation: the radiance accumulator aliases st["radiance"] on the
    # first chunk (f(a, donate(a)) is rejected)
    p2 = jax.jit(phase2_chunk)

    def combine(film, radiance, base_replay, fw, p0):
        # clamp for lanes that died before split_d (phase-2 rows arrive
        # already clamped; the clamp is idempotent)
        if settings.clamp_indirect > 0.0:
            ind = jnp.clip(
                radiance - base_replay, None, settings.clamp_indirect
            )
            radiance = base_replay + ind
        color = remove_nan(radiance) * fw[..., None]
        acc = jax.lax.dynamic_slice(film.accum, (p0, 0), (pb, 3))
        w = jax.lax.dynamic_slice(film.weight, (p0,), (pb,))
        return film._replace(
            accum=jax.lax.dynamic_update_slice(
                film.accum, acc + color, (p0, 0)
            ),
            weight=jax.lax.dynamic_update_slice(film.weight, w + fw, (p0,)),
        )

    comb = jax.jit(combine, donate_argnums=(0,))

    verbose = os.environ.get("AKR_SPLIT_VERBOSE", "0") == "1"

    def run_pass(arrays, film, start_sample):
        import sys
        import time as _t

        if npad > npix:
            film = film._replace(
                accum=jnp.pad(film.accum, ((0, npad - npix), (0, 0))),
                weight=jnp.pad(film.weight, ((0, npad - npix),)),
            )
        start = jnp.asarray(start_sample, jnp.uint32)
        for s in range(spp_chunk):
            sidx = start + jnp.uint32(s)
            for b in range(n_blocks):
                p0 = jnp.int32(b * pb)
                t0 = _t.time()
                st, perm, count, fw = p1(arrays, sidx, p0)
                cnt = int(count)  # the one host sync per block-sample
                t1 = _t.time()
                rad = st["radiance"]
                nch = -(-cnt // pc) if cnt else 0
                for c in range(nch):
                    rad = p2(arrays, st, perm, jnp.int32(c), rad)
                film = comb(film, rad, st["base_replay"], fw, p0)
                if verbose:
                    jax.block_until_ready(film)
                    print(
                        f"# split b{b}: p1 {t1 - t0:.3f}s "
                        f"(live {cnt}/{pb}) + {nch} p2+comb "
                        f"{_t.time() - t1:.3f}s",
                        file=sys.stderr, flush=True,
                    )
        if npad > npix:
            film = film._replace(
                accum=film.accum[:npix], weight=film.weight[:npix]
            )
        return film

    run_pass.n_blocks = n_blocks
    return run_pass


def _render_pass_fn(scene: Scene, settings: PTSettings, filt, width, height, spp_chunk, seed=0, sampler_config=None):
    """Build the jitted one-pass function (traced once, reused every pass).

    Routes to the split-compacted runner (_render_pass_fn_split) when
    _split_depth engages — decided HERE so every caller (render_pt, bench,
    tools) gets the production configuration.

    Renders `spp_chunk` samples per pixel per call with the sample loop
    INSIDE jit (lax.fori_loop) so one device dispatch covers the whole pass.
    Frames wider than max_wavefront_lanes trace in pixel blocks (one
    dispatch per block) so accel intermediates stay bounded regardless of
    resolution.
    """
    sd = _split_depth(scene, settings)
    if sd is not None:
        return _render_pass_fn_split(
            scene, settings, filt, width, height, spp_chunk, sd,
            seed=seed, sampler_config=sampler_config,
        )

    npix = width * height
    from ..core.lds import make_sampler

    pb = min(npix, max_wavefront_lanes(scene))
    n_blocks = -(-npix // pb)
    npad = n_blocks * pb

    def trace_block(arrays, sample_idx, pix):
        """One wavefront: pix [PB] uint32 (>= npix lanes are dead)."""
        sc = replace(scene, arrays=arrays)
        valid = pix < npix
        pixc = jnp.minimum(pix, npix - 1)
        sampler = make_sampler(sampler_config, pixc, sample_idx.astype(jnp.uint32), seed)
        sampler, u_film = sampler.next_2d()
        off, fw = filt.sample(u_film)
        p_film = (
            jnp.stack(
                [(pixc % width).astype(jnp.float32), (pixc // width).astype(jnp.float32)], -1
            )
            + 0.5
            + off
        )
        ray_o, ray_d = generate_rays(sc.camera, p_film)
        spectral = None
        if settings.color == "spectral":
            # hero-wavelength sample per lane (color.rs:49-76); one extra
            # sampler draw, taken after the film sample so the RGB mode's
            # draw order is untouched when spectral is off
            from ..core.spectral import sample_wavelengths

            sampler, u_lam = sampler.next_1d()
            spectral = sample_wavelengths(u_lam)
        radiance, aux, sampler = trace_paths(
            sc, settings, ray_o, ray_d, sampler, spectral=spectral
        )
        return radiance, jnp.where(valid, fw, 0.0)

    def one_sample(sample_idx, carry):
        film, arrays = carry
        pix = jnp.arange(npix, dtype=jnp.uint32)
        radiance, fw = trace_block(arrays, sample_idx, pix)
        # lane i IS pixel i: no scatter (pt.rs:1100 binning semantics)
        from ..core.film import add_samples_aligned

        film = add_samples_aligned(film, radiance, fw)
        return film, arrays

    def one_pass(arrays, film: Film, start_sample):
        start = start_sample.astype(jnp.int32)
        film, _ = jax.lax.fori_loop(
            start, start + spp_chunk, one_sample, (film, arrays)
        )
        return film

    if n_blocks == 1:
        return jax.jit(one_pass, donate_argnums=(1,))

    # Big frame: ONE pixel block per device dispatch, the block loop on the
    # host; the jitted step takes the block index as a traced arg, so every
    # block reuses one compiled graph.
    from ..core.film import remove_nan

    def block_samples(sample_idx, carry):
        film, arrays, p0 = carry
        pix = (p0 + jnp.arange(pb, dtype=jnp.int32)).astype(jnp.uint32)
        radiance, fw = trace_block(arrays, sample_idx, pix)
        color = remove_nan(radiance) * fw[..., None]
        acc = jax.lax.dynamic_slice(film.accum, (p0, 0), (pb, 3))
        w = jax.lax.dynamic_slice(film.weight, (p0,), (pb,))
        film = film._replace(
            accum=jax.lax.dynamic_update_slice(film.accum, acc + color, (p0, 0)),
            weight=jax.lax.dynamic_update_slice(film.weight, w + fw, (p0,)),
        )
        return film, arrays, p0

    def one_block_pass(arrays, film: Film, start_sample, block):
        start = start_sample.astype(jnp.int32)
        film = film._replace(  # pad so every pixel block is full-width
            accum=jnp.pad(film.accum, ((0, npad - npix), (0, 0))),
            weight=jnp.pad(film.weight, ((0, npad - npix),)),
        )
        p0 = block.astype(jnp.int32) * pb
        film, _, _ = jax.lax.fori_loop(
            start, start + spp_chunk, block_samples, (film, arrays, p0)
        )
        return film._replace(accum=film.accum[:npix], weight=film.weight[:npix])

    blocked = jax.jit(one_block_pass, donate_argnums=(1,))

    def run_pass(arrays, film, start_sample):
        for b in range(n_blocks):
            film = blocked(arrays, film, start_sample, jnp.int32(b))
        return film

    run_pass.n_blocks = n_blocks
    return run_pass


def render_pt(scene: Scene, config: PTConfig, task=None, progress_cb=None,
              checkpoint_path=None, checkpoint_every: int = 0, session=None):
    """Render, returning (image [H, W, 3] numpy, stats dict).

    checkpoint_path: if set, resume from it when compatible and save the
    film + pass counter there every `checkpoint_every` passes (new vs the
    reference, which cannot resume renders — SURVEY.md §5)."""
    import os as _os

    spectral_mode = getattr(config, "color", "rgb") == "spectral"
    if (
        _os.environ.get("AKR_PERSISTENT", "0") == "1"
        and not spectral_mode
        and checkpoint_path is None
        and (session is None or not session.save_intermediate)
    ):
        # persistent wavefront (compaction + refill) — same image
        # distribution, measured A/B in tests/test_wavefront.py
        from .wavefront import render_pt_wavefront

        return render_pt_wavefront(
            scene, config, task=task, progress_cb=progress_cb, session=session
        )
    width, height = scene.camera.width, scene.camera.height
    filt = filter_from_config(task.filter_config if task else None)
    settings = PTSettings(
        max_depth=config.max_depth,
        rr_depth=config.rr_depth,
        use_nee=config.use_nee,
        indirect_only=config.indirect_only,
        force_diffuse=config.force_diffuse,
        clamp_indirect=config.clamp_indirect,
        color=getattr(config, "color", "rgb"),
    )
    # samples per dispatch: amortize device-dispatch latency without
    # blowing up per-pass wall time (the sample loop is fori inside jit)
    spp_chunk = min(config.spp, config.spp_per_pass)
    seed = task.seed if task else 0
    sampler_config = task.sampler if task else None
    pass_fns: dict = {}

    def get_pass(chunk):
        if chunk not in pass_fns:
            pass_fns[chunk] = _render_pass_fn(
                scene, settings, filt, width, height, chunk,
                seed=seed, sampler_config=sampler_config,
            )
        return pass_fns[chunk]

    from ..stats import RenderStats

    render_stats = RenderStats()
    film = Film.new(width, height)
    done = 0  # samples accumulated so far (absolute sample index is the
    # sampler key, so pass chunking is free to vary without bias)
    if checkpoint_path:
        from ..checkpoint import load_checkpoint

        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck[1].get("kind") == "pt":
            film, meta, _ = ck
            done = int(meta.get("samples_done", 0))
    stats = {"time": [], "spp": []}
    t0 = time.time()

    from ..stats import profiler_from_env

    prof = profiler_from_env()
    pass_no = 0
    while done < config.spp:
        chunk = min(spp_chunk, config.spp - done)
        if prof is not None:
            with prof.profile(f"pt_pass[spp={chunk}]"):
                film = get_pass(chunk)(scene.arrays, film, jnp.uint32(done))
                jax.block_until_ready(film)
        else:
            film = get_pass(chunk)(scene.arrays, film, jnp.uint32(done))
        done += chunk
        pass_no += 1
        last = done >= config.spp
        if progress_cb and (pass_no % 16 == 0 or last):
            jax.block_until_ready(film)
            stats["time"].append(time.time() - t0)
            stats["spp"].append(done)
            progress_cb(done, config.spp, stats)
        if checkpoint_path and checkpoint_every and pass_no % checkpoint_every == 0:
            from ..checkpoint import save_checkpoint

            jax.block_until_ready(film)
            save_checkpoint(
                checkpoint_path, film, {"kind": "pt", "samples_done": done}
            )
        if session is not None and session.save_intermediate:
            # per-pass EXR dumps + stats series (pt.rs:1138-1155 protocol)
            from pathlib import Path

            from ..core.image_io import write_image

            jax.block_until_ready(film)
            ipath = str(Path(session.out_dir) / f"{session.name}-{done}.exr")
            write_image(ipath, np.asarray(develop(film, width, height)))
            render_stats.record(time.time() - t0, done, ipath)
        if session is not None and session.display is not None and (
            pass_no % 4 == 0 or last
        ):
            jax.block_until_ready(film)
            session.display(np.asarray(develop(film, width, height)))
    jax.block_until_ready(film)
    if prof is not None:
        prof.print_report()
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = done
    if session is not None:
        render_stats.record(stats["total_time"], stats["spp_total"])
        if session.save_stats:
            render_stats.write(session)
    img = np.asarray(develop(film, width, height))
    return img, stats
