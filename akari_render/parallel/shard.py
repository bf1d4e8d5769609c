"""Multi-chip data-parallel rendering over a jax.sharding.Mesh.

The reference is strictly single-device (SURVEY.md §2.3: no NCCL/MPI
anywhere); this module is the net-new multi-device scaling layer. Strategy (the
natural one for a replicated-scene renderer):

- scene arrays are REPLICATED on every chip (cbox ~KBs, big scenes ~100s MB —
  fits HBM; sharded-BVH is future work);
- PT shards PIXELS: lane i of a shard IS film row i of that shard, so a pass
  needs ZERO inter-chip communication — the film only gathers at develop;
- MCMC shards CHAINS: each chip runs its chain slice against a private
  full-frame splat film (stacked [ndev, ...], sharded on the stack axis);
  the films and the normalization counters sum once at develop — one
  collective per render instead of per pass;
- GPT shards PIXELS with the same private-film trick (gradient splats can
  cross shard borders, so films stay per-device and sum at develop).

Sample streams are keyed by absolute pixel/chain/sample ids, never by device
index, so every sharded renderer is bit-compatible with its single-chip
version up to float reduction order.
"""
from __future__ import annotations

import time
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import generate_rays
from ..core.film import Film, develop
from ..core.filters import filter_from_config
from ..core.pcg import Pcg32, U64
from ..core.samplers import IndependentSampler
from ..integrators.common import PTSettings, trace_paths


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("d",))


def _settings_from_config(config) -> PTSettings:
    return PTSettings(
        max_depth=config.max_depth,
        rr_depth=config.rr_depth,
        use_nee=config.use_nee,
        indirect_only=getattr(config, "indirect_only", False),
        force_diffuse=getattr(config, "force_diffuse", False),
        clamp_indirect=getattr(config, "clamp_indirect", 1000.0),
    )


def _stack_films(n: int, width: int, height: int, count: int = 1):
    """Per-device private films: [ndev, ...]-stacked Film pytree(s)."""
    def stack(film):
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (n,) + x.shape).copy(), film
        )

    films = tuple(stack(Film.new(width, height)) for _ in range(count))
    return films[0] if count == 1 else films


def _sum_films(stacked):
    return jax.tree_util.tree_map(lambda x: x.sum(axis=0), stacked)


# ---- PT -----------------------------------------------------------------------
def make_sharded_pass(scene, settings: PTSettings, filt, width: int, height: int,
                      mesh: Mesh, spp_chunk: int = 1, seed: int = 0,
                      sampler_config=None, lanes: int | None = None):
    """Build the jitted multi-chip pass: `spp_chunk` samples of a pixel
    BLOCK per dispatch, pixels sharded over "d", the sample loop INSIDE jit
    (lax.fori_loop) like the single-chip render_pt pass.

    `lanes` caps the per-device wavefront (integrators/pt.py::
    max_wavefront_lanes): each device traces `lanes` pixels of ITS OWN
    contiguous film-row range per dispatch (offset `base_local`), keeping
    the zero-communication property — a big frame is a host loop over
    base_local instead of one multi-GB dispatch. When lanes does not divide
    per_dev, dynamic_slice clamps the last block so a few rows are traced
    twice with IDENTICAL (pixel, sample)-keyed contributions — accum and
    weight scale together, so the developed pixel value is unchanged."""
    npix = width * height
    ndev = mesh.devices.size
    assert npix % ndev == 0, f"{npix} pixels not divisible by {ndev} devices"
    per_dev = npix // ndev
    lanes = per_dev if lanes is None else min(lanes, per_dev)
    from ..core.lds import make_sampler

    def shard_body(arrays, film, base_local, start_sample):
        # device k owns film rows [k*per_dev, (k+1)*per_dev); this dispatch
        # covers `lanes` of them starting at base_local -> pure local-slice
        # add, ZERO inter-chip communication per pass.
        sc = replace(scene, arrays=arrays)
        k = jax.lax.axis_index("d").astype(jnp.uint32)
        pix = (
            k * jnp.uint32(per_dev)
            + base_local.astype(jnp.uint32)
            + jnp.arange(lanes, dtype=jnp.uint32)
        )

        def one_sample(sample_idx, blk):
            sampler = make_sampler(
                sampler_config, pix, sample_idx.astype(jnp.uint32), seed
            )
            sampler, u_film = sampler.next_2d()
            off, fw = filt.sample(u_film)
            p_film = (
                jnp.stack(
                    [
                        (pix % width).astype(jnp.float32),
                        (pix // width).astype(jnp.float32),
                    ],
                    -1,
                )
                + 0.5
                + off
            )
            ray_o, ray_d = generate_rays(sc.camera, p_film)
            radiance, aux, _ = trace_paths(sc, settings, ray_o, ray_d, sampler)
            from ..core.film import add_samples_aligned

            return add_samples_aligned(blk, radiance, fw)

        start = start_sample.astype(jnp.int32)
        base = base_local.astype(jnp.int32)
        blk = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, base, lanes, 0), film
        )
        blk = jax.lax.fori_loop(start, start + spp_chunk, one_sample, blk)
        return jax.tree_util.tree_map(
            lambda x, b: jax.lax.dynamic_update_slice_in_dim(x, b, base, 0),
            film, blk,
        )

    sharded = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("d"), P(), P()),
        out_specs=P("d"),
        check_vma=False,
    )

    @jax.jit
    def one_pass(arrays, film, start_sample, base_local=jnp.uint32(0)):
        return sharded(arrays, film, base_local, start_sample)

    return one_pass


def render_pt_sharded(scene, config, task=None, mesh: Mesh | None = None,
                      progress_cb=None, checkpoint_path=None,
                      checkpoint_every: int = 0, session=None):
    """Multi-device PT render: in-jit spp chunking, pixel blocks under the
    wavefront lane cap, stats/save-intermediate sessions, checkpoint/resume
    — feature parity with the single-device render_pt host loop."""
    import os

    if (
        os.environ.get("AKR_PERSISTENT", "0") == "1"
        and checkpoint_path is None
        and (session is None or not session.save_intermediate)
    ):
        # persistent wavefront, sharded (same routing gate as render_pt)
        return render_pt_wavefront_sharded(
            scene, config, task=task, mesh=mesh, progress_cb=progress_cb,
            session=session,
        )

    mesh = mesh or make_mesh()
    width, height = scene.camera.width, scene.camera.height
    filt = filter_from_config(task.filter_config if task else None)
    settings = _settings_from_config(config)
    seed = task.seed if task else 0
    sampler_config = task.sampler if task else None
    spp_chunk = min(config.spp, config.spp_per_pass)

    # per-device wavefront cap (integrators/pt.py): big frames trace in
    # pixel blocks per device instead of one multi-GB dispatch
    from ..integrators.pt import max_wavefront_lanes

    ndev = mesh.devices.size
    npix = width * height
    per_dev = npix // max(ndev, 1)
    lanes = min(per_dev, max_wavefront_lanes(scene))
    n_blocks = -(-per_dev // lanes)
    lanes = -(-per_dev // n_blocks)

    pass_fns: dict = {}

    def get_pass(chunk):
        if chunk not in pass_fns:
            pass_fns[chunk] = make_sharded_pass(
                scene, settings, filt, width, height, mesh,
                spp_chunk=chunk, seed=seed, sampler_config=sampler_config,
                lanes=lanes,
            )
        return pass_fns[chunk]

    def run_pass(chunk, film, start_sample):
        fn = get_pass(chunk)
        for base in range(0, per_dev, lanes):
            film = fn(scene.arrays, film, jnp.uint32(start_sample),
                      jnp.uint32(base))
        return film

    from ..stats import RenderStats

    render_stats = RenderStats()
    film = Film.new(width, height)
    done = 0
    if checkpoint_path:
        from ..checkpoint import load_checkpoint

        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck[1].get("kind") == "pt":
            film, meta, _ = ck
            done = int(meta.get("samples_done", 0))
    stats = {"time": [], "spp": []}
    t0 = time.time()

    pass_no = 0
    while done < config.spp:
        chunk = min(spp_chunk, config.spp - done)
        film = run_pass(chunk, film, done)
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
            from pathlib import Path

            from ..core.image_io import write_image

            jax.block_until_ready(film)
            ipath = str(Path(session.out_dir) / f"{session.name}-{done}.exr")
            write_image(ipath, np.asarray(develop(film, width, height)))
            render_stats.record(time.time() - t0, done, ipath)
    jax.block_until_ready(film)
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = done
    stats["devices"] = mesh.devices.size
    if session is not None:
        render_stats.record(stats["total_time"], done)
        if session.save_stats:
            render_stats.write(session)
    img = np.asarray(develop(film, width, height))
    return img, stats


def render_pt_wavefront_sharded(scene, config, task=None,
                                mesh: Mesh | None = None, progress_cb=None,
                                session=None):
    """Multi-chip persistent wavefront: each device owns a contiguous film-
    row range and drains its own (local pixel, sample) queue with the
    single-chip compact+refill step (integrators/wavefront.py) — the queue
    split is embarrassingly parallel, films stay device-local (zero
    inter-chip communication per dispatch), and the GLOBAL (pixel, sample)
    sampler keying means every path is sampled identically to single-chip.
    """
    import os

    from ..integrators.common import _fuse_rays_mode
    from ..integrators.pt import max_wavefront_lanes
    from ..integrators.wavefront import _empty_lanes, make_step_fn

    mesh = mesh or make_mesh()
    ndev = mesh.devices.size
    width, height = scene.camera.width, scene.camera.height
    npix = width * height
    assert npix % ndev == 0, f"{npix} pixels not divisible by {ndev} devices"
    per_dev = npix // ndev
    filt = filter_from_config(task.filter_config if task else None)
    settings = _settings_from_config(config)
    seed = task.seed if task else 0
    sampler_config = task.sampler if task else None
    pool = min(per_dev * config.spp, max_wavefront_lanes(scene))
    fused = (
        _fuse_rays_mode()
        and settings.use_nee
        and scene.arrays.lights.num_lights > 0
        and not scene.has_alpha
    )
    total = per_dev * config.spp
    step = make_step_fn(scene, settings, filt, width, height, sampler_config,
                        seed, fused, npix_owned=per_dev)

    def shard_body(arrays, accum, weight, lanes, qhead, iters):
        k = jax.lax.axis_index("d").astype(jnp.uint32)
        a2, w2, l2, qh, na = step(
            arrays, accum, weight, lanes, qhead[0], jnp.int32(total),
            iters, pix_base=k * jnp.uint32(per_dev),
        )
        return a2, w2, l2, qh[None], na[None]

    lanes0 = _empty_lanes(scene, filt, width, height, ndev * pool,
                          sampler_config, seed, fused)
    lanes_spec = jax.tree_util.tree_map(
        lambda x: P("d") if x.ndim >= 1 and x.shape[0] == ndev * pool else P(),
        lanes0,
    )
    sharded = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("d"), P("d"), lanes_spec, P("d"), P()),
        out_specs=(P("d"), P("d"), lanes_spec, P("d"), P("d")),
        check_vma=False,
    )
    step_j = jax.jit(sharded, donate_argnums=(1, 2, 3, 4))

    accum = jnp.zeros((npix, 3))
    weight = jnp.zeros((npix,))
    lanes = lanes0
    qhead = jnp.zeros((ndev,), jnp.int32)

    stats = {"time": [], "spp": []}
    t0 = time.time()

    import os

    iters = int(os.environ.get("AKR_WF_ITERS", "0")) or 10 ** 9

    while True:
        accum, weight, lanes, qhead, n_active = step_j(
            scene.arrays, accum, weight, lanes, qhead, jnp.int32(iters)
        )
        qh = np.asarray(qhead)
        na = np.asarray(n_active)
        done_items = int(qh.sum()) - int(na.sum())
        if progress_cb is not None:
            stats["time"].append(time.time() - t0)
            stats["spp"].append(done_items // max(npix, 1))
            progress_cb(done_items // max(npix, 1), config.spp, stats)
        if session is not None and session.display is not None:
            film = Film(accum=accum, splat=jnp.zeros_like(accum), weight=weight)
            session.display(np.asarray(develop(film, width, height)))
        if (qh >= total).all() and (na == 0).all():
            break
    jax.block_until_ready(accum)
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = config.spp
    stats["devices"] = ndev
    film = Film(accum=accum, splat=jnp.zeros_like(accum), weight=weight)
    img = np.asarray(develop(film, width, height))
    if session is not None:
        from ..stats import RenderStats

        rs = RenderStats()
        rs.record(stats["total_time"], config.spp)
        if session.save_stats:
            rs.write(session)
    return img, stats


# ---- MCMC ----------------------------------------------------------------------
def render_mcmc_sharded(scene, config, task=None, mesh: Mesh | None = None,
                        progress_cb=None, session=None):
    """Multi-chip Kelemen PSSMLT: chains sharded over "d", one private
    full-frame splat film per device (summed once at develop). Chain sample
    streams are keyed by absolute chain index, so the render is statistically
    identical to the single-chip render_mcmc for the same config."""
    from ..integrators.mcmc import (
        _mcmc_settings,
        bootstrap_chains,
        make_mutate_step,
    )

    t_start = time.time()
    mesh = mesh or make_mesh()
    ndev = mesh.devices.size
    width, height = scene.camera.width, scene.camera.height
    npixels = width * height
    filt = filter_from_config(task.filter_config if task else None)
    settings, D = _mcmc_settings(config)
    C = -(-config.n_chains // ndev) * ndev  # round chains up to the mesh
    seed = task.seed if task else 0

    pss, cur_p, cur_color, cur_f, b_init, nb = bootstrap_chains(
        scene, settings, filt, config, D, C, seed
    )
    chain_rng = IndependentSampler.new(
        jnp.arange(C, dtype=jnp.uint32), seed=seed ^ 0xC4A1
    ).rng
    mutate_step = make_mutate_step(scene, settings, filt, config, D)

    def shard_body(arrays, pss, cur_p, cur_color, cur_f, rng, film_stack,
                   b, b_cnt, n_acc, n_mut, n_steps):
        # each shard: its chain slice + ITS OWN full film ([1, ...] slice)
        film = jax.tree_util.tree_map(lambda x: x[0], film_stack)
        carry = (pss, cur_p, cur_color, cur_f, rng, film,
                 b[0], b_cnt[0], n_acc[0], n_mut[0])
        carry = jax.lax.fori_loop(0, n_steps, mutate_step, carry)
        (pss, cur_p, cur_color, cur_f, rng, film, b0, bc0, na0, nm0) = carry
        film_stack = jax.tree_util.tree_map(lambda x: x[None], film)
        return (pss, cur_p, cur_color, cur_f, rng, film_stack,
                b0[None], bc0[None], na0[None], nm0[None])

    sharded = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(),) + (P("d"),) * 10 + (P(),),
        out_specs=(P("d"),) * 10,
        check_vma=False,
    )
    advance = jax.jit(sharded)

    film_stack = _stack_films(ndev, width, height)
    zeros_f = jnp.zeros((ndev,), jnp.float32)
    zeros_i = jnp.zeros((ndev,), jnp.int32)
    state = (pss, cur_p, cur_color, cur_f, chain_rng, film_stack,
             zeros_f, zeros_i, zeros_i, zeros_i)

    total_mutations = npixels * config.spp
    mutations_per_chain = max(1, total_mutations // C)
    per_dispatch = max(1, (npixels * config.spp_per_pass) // C)

    done = 0
    stats_series = {"time": [], "spp": []}
    pass_no = 0
    while done < mutations_per_chain:
        step = min(per_dispatch, mutations_per_chain - done)
        state = advance(scene.arrays, *state, jnp.int32(step))
        done += step
        pass_no += 1
        if progress_cb and (pass_no % 4 == 0 or done >= mutations_per_chain):
            jax.block_until_ready(state)
            stats_series["time"].append(time.time() - t_start)
            stats_series["spp"].append(done * C / npixels)
            progress_cb(done, mutations_per_chain, stats_series)
    jax.block_until_ready(state)
    (_, _, _, _, _, film_stack, b, b_cnt, n_acc, n_mut) = state

    film = _sum_films(film_stack)
    b_total = (b_init * nb + float(b.sum())) / (nb + int(b_cnt.sum()))
    eff_spp = done * C / npixels
    splat_scale = b_total / eff_spp
    img = np.asarray(develop(film, width, height, splat_scale=splat_scale))
    stats = {
        "total_time": time.time() - t_start,
        "b": b_total,
        "acceptance": float(n_acc.sum()) / max(1, int(n_mut.sum())),
        "spp_total": eff_spp,
        "devices": ndev,
    }

    if config.direct_spp > 0:
        from ..config import PTConfig

        direct_cfg = PTConfig(
            spp=config.direct_spp,
            max_depth=1,
            rr_depth=config.rr_depth,
            use_nee=config.use_nee,
            spp_per_pass=min(config.direct_spp, 32),
        )
        direct_img, dstats = render_pt_sharded(scene, direct_cfg, task, mesh=mesh)
        img = img + direct_img
        stats["direct_time"] = dstats["total_time"]
        stats["total_time"] = time.time() - t_start
    return img, stats


# ---- GPT -----------------------------------------------------------------------
def render_gpt_sharded(scene, config, task=None, mesh: Mesh | None = None,
                       progress_cb=None, shift_mode: str | None = None,
                       session=None):
    """Multi-chip gradient-domain PT: pixels sharded over "d"; each device
    accumulates six private full-frame films (gradient splats cross shard
    borders) summed once before reconstruction. Per-pixel PSS streams are
    keyed by absolute pixel id, so output matches single-chip render_gpt.

    Feature parity with single-device render_gpt's host loop: session
    stats / save-intermediate / display."""
    from ..integrators.gpt import DEFAULT_SHIFT_MODE, gpt_sample_films, screened_poisson
    from ..integrators.mcmc import sample_dimension

    t0 = time.time()
    if shift_mode is None:  # same resolution as render_gpt
        rc = getattr(config, "reconnect", None)
        shift_mode = (DEFAULT_SHIFT_MODE if rc is None
                      else ("reconnect" if rc else "pss"))
    mesh = mesh or make_mesh()
    ndev = mesh.devices.size
    width, height = scene.camera.width, scene.camera.height
    npix = width * height
    assert npix % ndev == 0, f"{npix} pixels not divisible by {ndev} devices"
    per_dev = npix // ndev
    filt = filter_from_config(task.filter_config if task else None)
    settings = PTSettings(
        max_depth=config.max_depth, rr_depth=config.rr_depth, use_nee=config.use_nee
    )
    D = sample_dimension(config.max_depth)
    seed = task.seed if task else 0

    def shard_body(arrays, films_stack, base_local, sample_idx, *, chunk):
        # device k samples pixels [k*per_dev + base, k*per_dev + base+chunk)
        # into its OWN six films (splats may land anywhere in the frame)
        k = jax.lax.axis_index("d").astype(jnp.uint32)
        pix = (
            k * jnp.uint32(per_dev)
            + base_local.astype(jnp.uint32)
            + jnp.arange(chunk, dtype=jnp.uint32)
        )
        films = tuple(
            jax.tree_util.tree_map(lambda x: x[0], f) for f in films_stack
        )
        films = gpt_sample_films(
            scene, config, filt, settings, D, seed, shift_mode,
            arrays, films, sample_idx, pix,
        )
        return tuple(
            jax.tree_util.tree_map(lambda x: x[None], f) for f in films
        )

    pass_fns: dict = {}

    def get_pass(chunk):
        if chunk not in pass_fns:
            sharded = shard_map(
                partial(shard_body, chunk=chunk),
                mesh=mesh,
                in_specs=(P(), P("d"), P(), P()),
                out_specs=P("d"),
                check_vma=False,
            )
            pass_fns[chunk] = jax.jit(
                lambda arrays, fs, base, s, _f=sharded: _f(arrays, fs, base, s),
                donate_argnums=(1,),
            )
        return pass_fns[chunk]

    films_stack = _stack_films(ndev, width, height, count=6)

    # one dispatch per device covers its whole pixel range
    chunk = per_dev
    base0 = 0

    from ..stats import RenderStats

    render_stats = RenderStats()
    stats_series = {"time": [], "spp": []}

    def _recon_current(films_stack):
        films01 = tuple(_sum_films(films_stack[i]) for i in range(3))
        p = develop(films01[0], width, height)
        return screened_poisson(
            p, develop(films01[1], width, height),
            develop(films01[2], width, height),
            None, iters=config.reconstruction_iter,
        )

    for s in range(config.spp):
        base = base0 if s == 0 else 0
        while base < per_dev:
            c = min(chunk, per_dev - base)
            films_stack = get_pass(c)(
                scene.arrays, films_stack, jnp.uint32(base), jnp.uint32(s)
            )
            base += c
        if progress_cb:
            jax.block_until_ready(films_stack)
            stats_series["time"].append(time.time() - t0)
            stats_series["spp"].append(s + 1)
            progress_cb(s + 1, config.spp, stats_series)
        if session is not None and session.save_intermediate:
            from pathlib import Path

            from ..core.image_io import write_image

            jax.block_until_ready(films_stack)
            ipath = str(Path(session.out_dir) / f"{session.name}-{s + 1}.exr")
            write_image(ipath, np.asarray(_recon_current(films_stack)))
            render_stats.record(time.time() - t0, s + 1, ipath)
        if session is not None and session.display is not None:
            jax.block_until_ready(films_stack)
            session.display(np.asarray(_recon_current(films_stack)))
    jax.block_until_ready(films_stack)

    films = tuple(_sum_films(f) for f in films_stack)
    primal = develop(films[0], width, height)
    gx = develop(films[1], width, height)
    gy = develop(films[2], width, height)
    primal_sq = develop(films[3], width, height)
    gx_sq = develop(films[4], width, height)
    gy_sq = develop(films[5], width, height)
    var_p = jnp.maximum(primal_sq - primal**2, 1e-8)
    var_gx = jnp.maximum(gx_sq - gx**2, 1e-8)
    var_gy = jnp.maximum(gy_sq - gy**2, 1e-8)
    recon = screened_poisson(
        primal, gx, gy,
        None if config.uniform_weights else (var_p, var_gx, var_gy),
        iters=config.reconstruction_iter,
    )
    img = np.asarray(recon)
    stats = {
        "total_time": time.time() - t0,
        "spp_total": config.spp,
        "devices": ndev,
        "primal": np.asarray(primal),
    }
    if session is not None:
        render_stats.record(stats["total_time"], config.spp)
        if session.save_stats:
            render_stats.write(session)
    return img, stats
