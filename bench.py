"""Benchmark: path-tracing throughput of the default PT pass on one GPU.

Measures, in this one process, the production pass that render_pt runs
(integrators/pt.py::_render_pass_fn) on:
  (a) cbox (scenes/cbox), 1024x1024, 16 spp, depth 12, rr depth 5, the
      pmj02bn sampler — upstream's PT job (scenes/cbox/pt.json) cut to
      16 spp;
  (b) classroom (scenes/classroom), 1920x1080, 1 spp, depth 12, rr depth 5
      (~590k effective triangles, 8 lights, instanced desks, textures).
"Paths" = camera samples (spp x pixels); each traces up to 12 bounces with
NEE. One pass compiles and warms up; the next is timed with
block_until_ready.

Prints ONE JSON line. Its `detail` names the device (JAX's platform, kind
and count), the card and its power limit as nvidia-smi reports them, and
XLA_FLAGS. A run that finds no GPU fails; it never measures the CPU.

Env: BENCH_RES / BENCH_SPP override (a); BENCH_SKIP_CLASSROOM=1 drops (b).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CBOX = ROOT / "scenes" / "cbox" / "scene.json"
CBOX_PT = ROOT / "scenes" / "cbox" / "pt.json"
CLASSROOM = ROOT / "scenes" / "classroom" / "scene.json"


def nvidia_smi() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def device_record() -> dict:
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "card": nvidia_smi(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def require_gpu() -> dict:
    """The device record, or SystemExit when JAX finds no GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {rec['platform']} ({rec['kind']})"
        )
    return rec


def time_pass(scene, spp: int, max_depth: int = 12, rr_depth: int = 5,
              sampler_config=None) -> dict:
    """Compile + warm one pass of `spp` samples, then time the next one."""
    import jax
    import jax.numpy as jnp

    from akari_render.core.film import Film
    from akari_render.core.filters import GaussianFilter
    from akari_render.integrators.common import PTSettings
    from akari_render.integrators.pt import _render_pass_fn

    w, h = scene.camera.width, scene.camera.height
    one_pass = _render_pass_fn(
        scene, PTSettings(max_depth=max_depth, rr_depth=rr_depth),
        GaussianFilter(1.5), w, h, spp, sampler_config=sampler_config,
    )
    t0 = time.perf_counter()
    film = one_pass(scene.arrays, Film.new(w, h), jnp.uint32(0))
    jax.block_until_ready(film)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    film = one_pass(scene.arrays, Film.new(w, h), jnp.uint32(spp))
    jax.block_until_ready(film)
    dt = time.perf_counter() - t0
    return {
        "res": f"{w}x{h}",
        "spp": spp,
        "max_depth": max_depth,
        "seconds": dt,
        "warm_seconds": warm,
        "mpaths_s": w * h * spp / dt / 1e6,
    }


def main():
    from akari_render.config import RenderTask
    from akari_render.scene import load_scene

    dev = require_gpu()
    res = int(os.environ.get("BENCH_RES", "1024"))
    spp = int(os.environ.get("BENCH_SPP", "16"))
    cbox = time_pass(load_scene(str(CBOX), width=res, height=res), spp,
                     sampler_config=RenderTask.from_file(CBOX_PT).sampler)
    print(f"[bench] cbox: {cbox}", file=sys.stderr, flush=True)
    detail = {"device": dev, "cbox": cbox}
    if not os.environ.get("BENCH_SKIP_CLASSROOM"):
        detail["classroom"] = time_pass(load_scene(str(CLASSROOM)), 1)
        print(f"[bench] classroom: {detail['classroom']}", file=sys.stderr,
              flush=True)
    print(json.dumps({
        "metric": "cbox_pt_throughput",
        "value": cbox["mpaths_s"],
        "unit": "Mpaths/s",
        "detail": detail,
    }), flush=True)


if __name__ == "__main__":
    main()
