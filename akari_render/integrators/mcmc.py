"""Kelemen-style PSSMLT Metropolis integrator.

Reference: crates/akari_integrator/src/mcmc_opt.rs (the active MCMC path) +
crates/akari_render/src/sampler/mcmc.rs (KELEMEN_MUTATE). Semantics kept:
bootstrap + CPU resampling (distribution.rs:92-115), Kelemen exponential
small-steps (sizes 1/1024..1/64) with large-step prob, expected-value
splatting of both states, on-device running normalization b, splat_scale
b/spp at readout (mcmc_opt.rs:600-622).

Array design: one CHAIN per lane (mcmc_opt.rs runs one chain per GPU thread —
embarrassingly parallel either way). Differences from the reference's
implementation strategy, same math:
- the per-dim lazy `last_modified` catch-up (mcmc_opt.rs:150-206) is
  unnecessary here: we mutate all D dims every step with vectorized ops,
  which is the same random walk the lazy scheme defers;
- accept/reject keeps cur/proposal PSS vectors as separate arrays instead of
  in-place backups.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import generate_rays
from ..config import MCMCConfig
from ..core.distribution import resample_with_f64
from ..core.film import Film, add_splats, add_samples, develop
from ..core.filters import filter_from_config
from ..core.pcg import Pcg32, U64, pcg32_next_f32
from ..core.samplers import IndependentSampler
from ..scene import Scene
from .common import PTSettings, trace_paths

KELEMEN_LOW = 1.0 / 1024.0
KELEMEN_HIGH = 1.0 / 64.0
KELEMEN_LOG_RATIO = -np.log(KELEMEN_HIGH / KELEMEN_LOW)


class ReplaySampler(NamedTuple):
    """Sampler that replays a PSS vector, falling back to fresh randoms
    beyond its dimension (ref LazyMcmcSampler, mcmc_opt.rs:61-120)."""

    pss: jnp.ndarray  # [C, D]
    dim: jnp.ndarray  # [C] current dimension counter
    rng: Pcg32  # fallback stream

    def next_1d(self):
        d = self.pss.shape[-1]
        rng, fresh = pcg32_next_f32(self.rng)
        idx = jnp.minimum(self.dim, d - 1)
        replay = jnp.take_along_axis(self.pss, idx[..., None], axis=-1)[..., 0]
        u = jnp.where(self.dim < d, replay, fresh)
        return ReplaySampler(self.pss, self.dim + 1, rng), u

    def next_2d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        return s, jnp.stack([a, b], -1)

    def next_3d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        s, c = s.next_1d()
        return s, jnp.stack([a, b, c], -1)


def sample_dimension(mcmc_depth: int) -> int:
    """4 + 1 + (1+depth)*7 (mcmc_opt.rs:230-232)."""
    return 4 + 1 + (1 + mcmc_depth) * 7


def kelemen_mutate(cur, u):
    """Exponential small-step mutation (sampler/mcmc.rs:92-126), batched."""
    add = u < 0.5
    uu = jnp.where(add, u * 2.0, (u - 0.5) * 2.0)
    dv = KELEMEN_HIGH * jnp.exp(KELEMEN_LOG_RATIO * uu)
    up = cur + dv
    up = jnp.where(up > 1.0, up - 1.0, up)
    dn = cur - dv
    dn = jnp.where(dn < 0.0, dn + 1.0, dn)
    return jnp.where(add, up, dn)


def _evaluate(scene: Scene, settings: PTSettings, filt, pss, fallback_rng):
    """PSS vector -> (p_film [C,2], radiance [C,3], f [C]) (mcmc_opt.rs:253-304)."""
    width, height = scene.camera.width, scene.camera.height
    sampler = ReplaySampler(pss, jnp.zeros(pss.shape[0], jnp.int32), fallback_rng)
    sampler, u_pix = sampler.next_2d()
    res = jnp.array([width, height], jnp.float32)
    pix = jnp.clip(
        jnp.floor(u_pix * res).astype(jnp.int32), 0, jnp.array([width - 1, height - 1])
    )
    sampler, u_film = sampler.next_2d()
    off, fw = filt.sample(u_film)
    p_film = pix.astype(jnp.float32) + 0.5 + off
    ray_o, ray_d = generate_rays(scene.camera, p_film)
    radiance, _, sampler = trace_paths(scene, settings, ray_o, ray_d, sampler)
    radiance = radiance * fw[..., None]
    f = jnp.clip(jnp.max(radiance, axis=-1), 0.0, 1e5)  # scalar_contribution
    return p_film, radiance, f, sampler.rng


def _mcmc_settings(config: MCMCConfig):
    mcmc_depth = config.mcmc_depth if config.mcmc_depth is not None else config.max_depth
    indirect_only = config.direct_spp >= 0
    return (
        PTSettings(
            max_depth=config.max_depth,
            rr_depth=config.rr_depth,
            use_nee=config.use_nee,
            indirect_only=indirect_only,
        ),
        sample_dimension(mcmc_depth),
    )


def bootstrap_chains(scene: Scene, settings, filt, config: MCMCConfig, D: int,
                     C: int, seed: int):
    """Bootstrap + CPU resample + initial chain states (mcmc_opt.rs:309-408).
    Returns (pss [C,D], cur_p, cur_color, cur_f, b_init, nb)."""
    nb = config.n_bootstrap
    boot_eval = jax.jit(
        lambda pss, rng: _evaluate(scene, settings, filt, pss, rng)[2]
    )

    # generate bootstrap PSS vectors deterministically from their index
    def boot_pss(idx):
        rng = Pcg32.new_seq(U64(jnp.full_like(idx, seed ^ 0xB00), idx))
        us = []
        for _ in range(D):
            rng, u = pcg32_next_f32(rng)
            us.append(u)
        return jnp.stack(us, -1)

    boot_chunk = min(nb, 1 << 17)
    fs = []
    make_pss = jax.jit(boot_pss)
    for start in range(0, nb, boot_chunk):
        idx = jnp.arange(start, min(start + boot_chunk, nb), dtype=jnp.uint32)
        pss = make_pss(idx)
        rng = IndependentSampler.new(idx, seed=seed ^ 0xF00).rng
        fs.append(np.asarray(boot_eval(pss, rng)))
    fs = np.concatenate(fs)
    b_init = float(fs.mean())
    assert b_init > 0.0, "bootstrap failed: black image?"
    host_rng = np.random.default_rng(seed)
    chain_idx = resample_with_f64(fs, host_rng.uniform(size=C))
    pss = make_pss(jnp.asarray(chain_idx.astype(np.uint32)))
    rng0 = IndependentSampler.new(
        jnp.asarray(chain_idx.astype(np.uint32)), seed=seed ^ 0xF00
    ).rng
    cur_p, cur_color, cur_f, _ = jax.jit(
        lambda p, r: _evaluate(scene, settings, filt, p, r)
    )(pss, rng0)
    return pss, cur_p, cur_color, cur_f, b_init, nb


def make_mutate_step(scene: Scene, settings, filt, config: MCMCConfig, D: int):
    """One Kelemen mutation + expected-value splat step over a carry of
    chain state (mcmc_opt.rs:409-560), reusable by the sharded path."""
    width, height = scene.camera.width, scene.camera.height

    def mutate_step(i, carry):
        (pss, cur_p, cur_color, cur_f, rng, film, b, b_cnt, n_acc, n_mut) = carry
        rng, u_large = pcg32_next_f32(rng)
        is_large = u_large < config.large_step_prob
        # proposal PSS: large = fresh; small = kelemen on all dims
        us = []
        for _ in range(D):
            rng, u = pcg32_next_f32(rng)
            us.append(u)
        u_mat = jnp.stack(us, -1)  # [C, D]
        us2 = []
        for _ in range(D):
            rng, u = pcg32_next_f32(rng)
            us2.append(u)
        fresh = jnp.stack(us2, -1)
        if config.exponential_mutation:
            small = kelemen_mutate(pss, u_mat)
        else:
            from ..core.sampling import sample_gaussian

            small = pss + sample_gaussian(u_mat) * config.small_sigma
            small = small - jnp.floor(small)
        # image-space mutation (mcmc_opt.rs:163-215): with prob
        # image_mutation_prob a small step perturbs ONLY the pixel dims 0-1
        # by a gaussian of image_mutation_size (fraction of the image),
        # leaving the path dims untouched
        if config.image_mutation_size is not None:
            from ..core.sampling import sample_gaussian as _sg

            rng, u_imgsel = pcg32_next_f32(rng)
            prob = getattr(config, "image_mutation_prob", 0.0) or 0.5
            is_img = (u_imgsel < prob) & ~is_large
            img_step = _sg(u_mat[:, :2]) * config.image_mutation_size
            img_dims = jnp.mod(pss[:, :2] + img_step, 1.0)
            small_img = jnp.concatenate([img_dims, pss[:, 2:]], axis=1)
            small = jnp.where(is_img[..., None], small_img, small)
        prop = jnp.where(is_large[..., None], fresh, small)
        prop_p, prop_color, prop_f, rng = _evaluate(scene, settings, filt, prop, rng)
        b = b + jnp.where(is_large, prop_f, 0.0).sum()
        b_cnt = b_cnt + is_large.sum()
        accept = jnp.where(
            jnp.isfinite(prop_f),
            jnp.where(
                (cur_f == 0.0) | ~jnp.isfinite(cur_f),
                1.0,
                jnp.clip(prop_f / jnp.maximum(cur_f, 1e-30), 0.0, 1.0),
            ),
            0.0,
        )
        # expected-value splats of both states (mcmc_opt.rs:468-480)
        film = add_splats(
            film, prop_p, prop_color / jnp.maximum(prop_f, 1e-30)[..., None],
            accept, width, height, mask=accept > 0,
        )
        film = add_splats(
            film, cur_p, cur_color / jnp.maximum(cur_f, 1e-30)[..., None],
            (1.0 - accept), width, height, mask=cur_f > 0,
        )
        rng, u_acc = pcg32_next_f32(rng)
        take = u_acc < accept
        pss = jnp.where(take[..., None], prop, pss)
        cur_p = jnp.where(take[..., None], prop_p, cur_p)
        cur_color = jnp.where(take[..., None], prop_color, cur_color)
        cur_f = jnp.where(take, prop_f, cur_f)
        n_acc = n_acc + (take & ~is_large).sum()
        n_mut = n_mut + (~is_large).sum()
        return (pss, cur_p, cur_color, cur_f, rng, film, b, b_cnt, n_acc, n_mut)

    return mutate_step


def _mcmc_fingerprint(config: MCMCConfig, width, height, C, D, seed):
    """Resume-compatibility key: everything that shapes the chain state or
    the mutation stream EXCEPT the mutation budget (spp), so a checkpoint
    taken at a lower spp can resume toward a higher one."""
    return [
        width, height, C, D, seed, config.n_bootstrap,
        float(config.large_step_prob), bool(config.exponential_mutation),
        None if config.image_mutation_size is None
        else float(config.image_mutation_size),
        config.direct_spp,
    ]


def render_mcmc(scene: Scene, config: MCMCConfig, task=None, progress_cb=None,
                session=None, checkpoint_path=None, checkpoint_every: int = 0):
    """checkpoint_path: resume from it when compatible and save the film +
    full chain state (PSS vectors, current-state cache, rng limbs, b
    normalization counters) there every `checkpoint_every` dispatches —
    SURVEY.md §5's "film + sampler/chain state" (the reference cannot resume
    renders at all)."""
    t_start = time.time()
    width, height = scene.camera.width, scene.camera.height
    npixels = width * height
    filt = filter_from_config(task.filter_config if task else None)
    settings, D = _mcmc_settings(config)
    C = config.n_chains
    seed = task.seed if task else 0
    fp = _mcmc_fingerprint(config, width, height, C, D, seed)

    done = 0
    resumed = None
    if checkpoint_path:
        from ..checkpoint import load_checkpoint

        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck[1].get("kind") == "mcmc" and ck[1].get("fp") == fp:
            resumed = ck

    if resumed is not None:
        film, meta, x = resumed
        done = int(meta["done"])
        b_init = float(meta["b_init"])
        nb = int(meta["nb"])
        pss = jnp.asarray(x["pss"])
        cur_p = jnp.asarray(x["cur_p"])
        cur_color = jnp.asarray(x["cur_color"])
        cur_f = jnp.asarray(x["cur_f"])
        chain_rng = Pcg32(
            state=U64(jnp.asarray(x["rng_sh"]), jnp.asarray(x["rng_sl"])),
            inc=U64(jnp.asarray(x["rng_ih"]), jnp.asarray(x["rng_il"])),
        )
        b = jnp.float32(float(x["b"]))
        b_cnt = jnp.int32(int(x["b_cnt"]))
        n_acc = jnp.int32(int(x["n_acc"]))
        n_mut = jnp.int32(int(x["n_mut"]))
    else:
        pss, cur_p, cur_color, cur_f, b_init, nb = bootstrap_chains(
            scene, settings, filt, config, D, C, seed
        )
        chain_rng = IndependentSampler.new(
            jnp.arange(C, dtype=jnp.uint32), seed=seed ^ 0xC4A1
        ).rng
        film = Film.new(width, height)
        b = jnp.float32(0.0)
        b_cnt = jnp.int32(0)
        n_acc = jnp.int32(0)
        n_mut = jnp.int32(0)
    mutate_step = make_mutate_step(scene, settings, filt, config, D)

    @jax.jit
    def advance(carry, n_steps):
        return jax.lax.fori_loop(0, n_steps, mutate_step, carry)

    carry = (pss, cur_p, cur_color, cur_f, chain_rng, film, b, b_cnt, n_acc, n_mut)

    total_mutations = npixels * config.spp
    mutations_per_chain = max(1, total_mutations // C)
    per_dispatch = max(1, (npixels * config.spp_per_pass) // C)

    from ..stats import RenderStats

    render_stats = RenderStats()
    stats_series = {"time": [], "spp": []}
    pass_no = 0

    def _current_estimate(carry):
        """Develop the film under the CURRENT normalization estimate."""
        film_c, b_c, b_cnt_c = carry[5], carry[6], carry[7]
        b_est = (b_init * nb + float(b_c)) / (nb + int(b_cnt_c))
        spp_so_far = max(done, 1) * C / npixels
        return np.asarray(
            develop(film_c, width, height, splat_scale=b_est / spp_so_far)
        )

    from ..stats import profiler_from_env

    prof = profiler_from_env()
    while done < mutations_per_chain:
        step = min(per_dispatch, mutations_per_chain - done)
        if prof is not None:
            with prof.profile(f"mcmc_advance[steps={step}]"):
                carry = advance(carry, jnp.int32(step))
                jax.block_until_ready(carry)
        else:
            carry = advance(carry, jnp.int32(step))
        done += step
        pass_no += 1
        if checkpoint_path and checkpoint_every and pass_no % checkpoint_every == 0:
            from ..checkpoint import save_checkpoint

            jax.block_until_ready(carry)
            (c_pss, c_p, c_col, c_f, c_rng, c_film, c_b, c_bc, c_na, c_nm) = carry
            save_checkpoint(
                checkpoint_path, c_film,
                {"kind": "mcmc", "done": done, "b_init": b_init, "nb": nb,
                 "fp": fp},
                {
                    "pss": c_pss, "cur_p": c_p, "cur_color": c_col,
                    "cur_f": c_f,
                    "rng_sh": c_rng.state.hi, "rng_sl": c_rng.state.lo,
                    "rng_ih": c_rng.inc.hi, "rng_il": c_rng.inc.lo,
                    "b": c_b, "b_cnt": c_bc, "n_acc": c_na, "n_mut": c_nm,
                },
            )
        last = done >= mutations_per_chain
        if progress_cb and (pass_no % 4 == 0 or last):
            jax.block_until_ready(carry)
            stats_series["time"].append(time.time() - t_start)
            stats_series["spp"].append(done * C / npixels)
            progress_cb(done, mutations_per_chain, stats_series)
        if session is not None and session.save_intermediate:
            from pathlib import Path

            from ..core.image_io import write_image

            jax.block_until_ready(carry)
            eff = done * C / npixels
            ipath = str(Path(session.out_dir) / f"{session.name}-{pass_no}.exr")
            write_image(ipath, _current_estimate(carry))
            render_stats.record(time.time() - t_start, eff, ipath)
        if session is not None and session.display is not None and (
            pass_no % 4 == 0 or done >= mutations_per_chain
        ):
            jax.block_until_ready(carry)
            session.display(_current_estimate(carry))
    jax.block_until_ready(carry)
    if prof is not None:
        prof.print_report()
    (pss, cur_p, cur_color, cur_f, chain_rng, film, b, b_cnt, n_acc, n_mut) = carry

    # ---- reconstruct (mcmc_opt.rs:600-622) ----
    b_total = (b_init * nb + float(b)) / (nb + int(b_cnt))
    eff_spp = done * C / npixels
    splat_scale = b_total / eff_spp
    accept_rate = float(n_acc) / max(1, int(n_mut))

    img = np.asarray(develop(film, width, height, splat_scale=splat_scale))
    stats = {
        "total_time": time.time() - t_start,
        "b": b_total,
        "acceptance": accept_rate,
        "spp_total": eff_spp,
    }
    if session is not None:
        render_stats.record(stats["total_time"], eff_spp)
        if session.save_stats:
            render_stats.write(session)

    # ---- separate direct pass (mcmc_opt.rs:705-729) ----
    if config.direct_spp > 0:
        from ..config import PTConfig
        from .pt import render_pt

        direct_cfg = PTConfig(
            spp=config.direct_spp,
            max_depth=1,
            rr_depth=config.rr_depth,
            use_nee=config.use_nee,
            spp_per_pass=min(config.direct_spp, 32),
        )
        direct_img, dstats = render_pt(scene, direct_cfg, task)
        img = img + direct_img
        stats["direct_time"] = dstats["total_time"]
        stats["total_time"] = time.time() - t_start
    return img, stats
