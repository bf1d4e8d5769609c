#!/usr/bin/env python3
"""Smoke test of the renderer on NVIDIA GPUs, in one process.

    python chip_smoke.py                # phases 1-5 on one card
    python chip_smoke.py --four-cards   # phase 6 only: the sharded path
    python chip_smoke.py --four-cards --reference DIR
        # phase 6 against the cbox.exr / classroom.exr phases 2-3 wrote

Phases (every one must pass; none catches its own failure):
 1. device: JAX's first device must be a GPU. Prints the card's name and
    power limit (nvidia-smi) and XLA_FLAGS.
 2. cbox, upstream's PT job (scenes/cbox/pt.json: pmj02bn, gaussian r=1.5,
    depth 12, rr 5) at 1024^2 cut to 16 spp, through cli.main: the EXR is
    finite and its channel means lie in CBOX_MEAN_BAND. Then the same pass
    timed warm (bench.time_pass): seconds and Mpaths/s.
 3. classroom at 1920x1080 through cli.main, PT depth 12, rr 5, 1 spp:
    finite and not black; seconds and Mpaths/s of the CLI render, first
    pass, compile included.
 4. against the plain reference: the same seeded PT pass on the GPU and on
    JAX's host CPU backend in this process (cbox 64^2 16 spp, classroom
    96x54 1 spp); channel means and the per-pixel median and 99th
    percentile absolute difference within the limits below.
 5. mcmc, gpt and aov on cbox 64^2 through cli.main: finite; the mcmc and
    gpt means within 30% of the phase-4 PT mean (the tolerance of
    tests/test_integrators.py).
 6. (--four-cards only) `cli --devices 4` on cbox 1024^2 (16 spp) and
    classroom 1920x1080 (1 spp) against the one-card render of the same
    job (rendered here, or read from --reference), after checking that the
    sharded film really lives on four devices.

The last line of stdout is {"ok": true, "device": {...}}; nothing is
printed there when a phase fails, and the exit code is then non-zero.
Images and method files go to <checkout>/.cache/smoke.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# without the repository around this script the import fails here, before
# any phase runs
import akari_render  # noqa: E402,F401

CBOX = ROOT / "scenes" / "cbox" / "scene.json"
CBOX_PT = ROOT / "scenes" / "cbox" / "pt.json"
CLASSROOM = ROOT / "scenes" / "classroom" / "scene.json"
OUT = ROOT / ".cache" / "smoke"

# cbox depth-12 channel means: 1024 spp at 64^2 on the CPU backend, NEE
# [0.1856, 0.1204, 0.0339] and BSDF-only [0.1868, 0.1210, 0.0341] agree to
# 0.6%. A 16-spp 1024^2 frame has ~0.1% sampling error in its mean; the
# band allows 3% for resolution and filter effects.
CBOX_ARGS = ["-s", str(CBOX), "-m", str(CBOX_PT), "--spp", "16"]
CLASSROOM_JOB = {"type": "pt", "spp": 1, "spp_per_pass": 1, "max_depth": 12,
                 "rr_depth": 5}
CBOX_MEAN = (0.1856, 0.1204, 0.0339)
CBOX_MEAN_BAND = 0.03

# GPU vs CPU backend on identical sample streams. Lanes differ only by
# summation order and transcendental ulps, which may flip a rare Russian-
# roulette or lobe decision. Measured on an H100 (PERF.md, PR 1): max
# channel-mean rel diff 2.5e-6 (cbox) and 3.9e-6 (classroom), median pixel
# |diff| 1.5e-8 and 7.2e-7, p99 pixel |diff| 1.1e-4 x the image mean. Each
# limit sits about 10x above those readings. tools/precision_control.py
# checks them against TF32 in the instance, albedo-table and colour
# contractions (PERF.md has its readings).
MEAN_RTOL = 5e-5
MEDIAN_ATOL = 1e-5
P99_REL = 1e-3

# the integrators' agreement with PT (tests/test_integrators.py)
INTEGRATOR_RTOL = 0.3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def write_method(name: str, method: dict) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    doc = {"method": method,
           "film": {"out": str(OUT / f"{name}.exr"),
                    "filter": {"type": "gaussian", "radius": 1.5}}}
    p = OUT / f"{name}.json"
    p.write_text(json.dumps(doc))
    return p


def cli_render(argv: list[str], out: Path):
    from akari_render import cli
    from akari_render.core.image_io import read_exr

    t0 = time.perf_counter()
    cli.main(argv + ["-o", str(out)])
    dt = time.perf_counter() - t0
    return read_exr(out), dt


def finite_and_lit(img, what: str) -> None:
    import numpy as np

    check(np.isfinite(img).all(), f"{what}: non-finite pixels")
    lit = float((img.max(axis=-1) > 0).mean())
    check(img.mean() > 1e-3 and lit > 0.5,
          f"{what}: black image (mean {img.mean()}, lit fraction {lit})")


def phase_device():
    t0 = phase("phase 1: device")
    import os

    import bench

    dev = bench.require_gpu()
    log(f"card: {dev['card']}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"jax devices: {dev['count']} x {dev['kind']} ({dev['platform']})")
    log(f"phase 1 ok ({time.perf_counter() - t0:.1f} s)")
    return dev


def phase_cbox():
    import numpy as np

    import bench
    from akari_render.config import RenderTask
    from akari_render.scene import load_scene

    t0 = phase("phase 2: cbox 1024^2, upstream PT job at 16 spp, via cli")
    img, wall = cli_render(CBOX_ARGS, OUT / "cbox.exr")
    check(img.shape == (1024, 1024, 3), f"cbox shape {img.shape}")
    finite_and_lit(img, "cbox")
    mean = img.mean(axis=(0, 1))
    log(f"cbox cli: {wall:.2f} s wall (load + compile + render), "
        f"mean {mean.tolist()}")
    rel = np.abs(mean / np.asarray(CBOX_MEAN) - 1.0)
    check((rel <= CBOX_MEAN_BAND).all(),
          f"cbox mean {mean.tolist()} outside {CBOX_MEAN} +- {CBOX_MEAN_BAND:.0%}")
    task = RenderTask.from_file(CBOX_PT)
    r = bench.time_pass(load_scene(str(CBOX)), 16, sampler_config=task.sampler)
    log(f"cbox pass: {r['seconds']:.4f} s for 16 spp at 1024^2 "
        f"= {r['mpaths_s']:.3f} Mpaths/s (warm-up pass {r['warm_seconds']:.2f} s)")
    log(f"phase 2 ok ({time.perf_counter() - t0:.1f} s)")
    return r


def phase_classroom():
    t0 = phase("phase 3: classroom 1920x1080, PT d12 rr5 1 spp, via cli")
    m = write_method("classroom_pt", CLASSROOM_JOB)
    img, wall = cli_render(["-s", str(CLASSROOM), "-m", str(m)],
                           OUT / "classroom.exr")
    check(img.shape == (1080, 1920, 3), f"classroom shape {img.shape}")
    finite_and_lit(img, "classroom")
    log(f"classroom cli: {wall:.2f} s wall (load + compile + render) "
        f"= {1920 * 1080 / wall / 1e6:.4f} Mpaths/s first pass, "
        f"mean {img.mean(axis=(0, 1)).tolist()}")
    log(f"phase 3 ok ({time.perf_counter() - t0:.1f} s)")


def _render_on(device, scene_path, w, h, spp):
    import jax

    from akari_render.config import PTConfig, RenderTask
    from akari_render.integrators.pt import render_pt
    from akari_render.scene import load_scene

    task = RenderTask.from_file(CBOX_PT)
    with jax.default_device(device):
        scene = load_scene(str(scene_path), width=w, height=h)
        img, _ = render_pt(
            scene, PTConfig(spp=spp, spp_per_pass=spp, max_depth=12, rr_depth=5),
            task=task,
        )
    return img


REFERENCE_JOBS = (("cbox", CBOX, 64, 64, 16), ("classroom", CLASSROOM, 96, 54, 1))


def reference_gaps(name, path, w, h, spp) -> dict:
    """Render one seeded PT pass on the GPU and on the CPU backend; return
    both images and their gaps."""
    import jax
    import numpy as np

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    t1 = time.perf_counter()
    a = _render_on(gpu, path, w, h, spp)
    t2 = time.perf_counter()
    b = _render_on(cpu, path, w, h, spp)
    t3 = time.perf_counter()
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    diff = np.abs(a - b).max(axis=-1)
    r = {"gpu": a, "cpu": b,
         "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
         "mean_rel": float(np.max(np.abs(ma / mb - 1.0))),
         "median": float(np.median(diff)),
         "p99_rel": float(np.percentile(diff, 99)) / float(mb.mean()),
         "exact": float((a == b).all(axis=-1).mean())}
    log(f"{name} {w}x{h} {spp} spp: gpu mean {ma.tolist()} "
        f"({t2 - t1:.1f} s), cpu mean {mb.tolist()} ({t3 - t2:.1f} s); "
        f"max mean rel diff {r['mean_rel']:.2e}, pixel |diff| median "
        f"{r['median']:.2e}, p99 {r['p99_rel']:.2e} x mean, bit-equal "
        f"pixels {r['exact']:.3f}")
    return r


def reference_failures(name: str, r: dict) -> list[str]:
    """The phase-4 limits that the gaps `r` break."""
    fails = []
    if not r["finite"]:
        fails.append(f"{name}: non-finite pixels")
    if r["mean_rel"] > MEAN_RTOL:
        fails.append(f"{name}: means differ by {r['mean_rel']:.2e} > {MEAN_RTOL}")
    if r["median"] > MEDIAN_ATOL:
        fails.append(f"{name}: median |diff| {r['median']:.2e} > {MEDIAN_ATOL}")
    if r["p99_rel"] > P99_REL:
        fails.append(f"{name}: p99 |diff| {r['p99_rel']:.2e} x mean > {P99_REL}")
    return fails


def phase_reference():
    t0 = phase("phase 4: GPU against the CPU backend, same seeded PT pass")
    out = {}
    for job in REFERENCE_JOBS:
        r = reference_gaps(*job)
        fails = reference_failures(job[0], r)
        check(not fails, "; ".join(fails))
        out[job[0]] = r["gpu"]
    log(f"phase 4 ok ({time.perf_counter() - t0:.1f} s)")
    return out


def phase_integrators(pt_cbox):
    import numpy as np

    t0 = phase("phase 5: mcmc, gpt, aov on cbox 64^2 via cli")
    ref = pt_cbox.mean(axis=(0, 1))
    jobs = {
        "mcmc": {"type": "mcmc", "spp": 16, "spp_per_pass": 16, "max_depth": 12,
                 "rr_depth": 5, "n_chains": 1024, "n_bootstrap": 16384,
                 "direct_spp": 16},
        "gpt": {"type": "gpt", "spp": 8, "spp_per_pass": 8, "max_depth": 12,
                "rr_depth": 5},
        "aov": {"type": "aov", "spp": 4},
    }
    for name, method in jobs.items():
        t1 = time.perf_counter()
        m = write_method(f"cbox_{name}", method)
        img, wall = cli_render(["-s", str(CBOX), "-m", str(m), "--res", "64"],
                               OUT / f"cbox_{name}.exr")
        check(np.isfinite(img).all(), f"{name}: non-finite pixels")
        mean = img.mean(axis=(0, 1))
        log(f"{name}: mean {mean.tolist()} ({time.perf_counter() - t1:.1f} s)")
        if name in ("mcmc", "gpt"):
            rel = float(np.max(np.abs(mean / ref - 1.0)))
            check(rel <= INTEGRATOR_RTOL,
                  f"{name} mean {mean.tolist()} vs PT {ref.tolist()}: {rel:.2f}")
        else:
            finite_and_lit(img, name)
    log(f"phase 5 ok ({time.perf_counter() - t0:.1f} s)")


def phase_four_cards(reference: Path | None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from akari_render.config import PTConfig
    from akari_render.core.film import Film
    from akari_render.core.filters import GaussianFilter
    from akari_render.core.image_io import read_exr
    from akari_render.parallel.shard import (
        _settings_from_config, make_mesh, make_sharded_pass,
    )
    from akari_render.scene import load_scene

    t0 = phase("phase 6: sharded PT on four cards against one card")
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    mesh = make_mesh(4)
    scene = load_scene(str(CBOX), width=64, height=64)
    one_pass = make_sharded_pass(
        scene, _settings_from_config(PTConfig(max_depth=12, rr_depth=5)),
        GaussianFilter(1.5), 64, 64, mesh,
    )
    film = one_pass(scene.arrays, Film.new(64, 64), jnp.uint32(0))
    devs = film.accum.sharding.device_set
    log(f"sharded film on {len(devs)} devices: {sorted(d.id for d in devs)}")
    check(len(devs) == 4, "the sharded film does not span four devices")

    m = write_method("classroom_pt", CLASSROOM_JOB)
    for name, argv in (("cbox", CBOX_ARGS),
                       ("classroom", ["-s", str(CLASSROOM), "-m", str(m)])):
        if reference is not None:
            one, t_one = read_exr(reference / f"{name}.exr"), float("nan")
        else:
            one, t_one = cli_render(argv, OUT / f"{name}.exr")
        four, t_four = cli_render(argv + ["--devices", "4"],
                                  OUT / f"{name}_4cards.exr")
        check(one.shape == four.shape, f"{name}: {one.shape} vs {four.shape}")
        check(np.isfinite(four).all(), f"{name}: non-finite pixels on 4 cards")
        exact = float((one == four).all(axis=-1).mean())
        diff = np.abs(one - four).max(axis=-1)
        m1, m4 = one.mean(axis=(0, 1)), four.mean(axis=(0, 1))
        rel = float(np.max(np.abs(m4 / m1 - 1.0)))
        log(f"{name}: 1 card {t_one:.1f} s, 4 cards {t_four:.1f} s (cli wall); "
            f"bit-equal pixels {exact:.4f}, max |diff| {diff.max():.3e}, "
            f"median {np.median(diff):.2e}, mean rel diff {rel:.2e}")
        # the shards key samples by absolute pixel id, so the two images
        # differ only where the two compiled programs round differently
        check(rel <= MEAN_RTOL, f"{name}: 4-card mean off by {rel:.2e}")
        check(float(np.median(diff)) <= MEDIAN_ATOL,
              f"{name}: median |diff| {np.median(diff):.2e}")
    log(f"phase 6 ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded four-card phase")
    ap.add_argument("--reference", type=Path, default=None,
                    help="with --four-cards: directory holding the one-card "
                         "cbox.exr and classroom.exr of phases 2-3")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = phase_device()
    if args.four_cards:
        phase_four_cards(args.reference)
    else:
        phase_cbox()
        phase_classroom()
        pt = phase_reference()
        phase_integrators(pt["cbox"])
    log(f"all phases ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
