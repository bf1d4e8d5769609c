"""akari_render — a physically-based renderer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
shiinamiyuki/akari_render (Rust + LuisaCompute): scenegraph JSON loading,
Cycles shader-graph subset compilation, wavefront path tracing with NEE+MIS,
Kelemen PSSMLT, gradient-domain PT, and AOV rendering — with multi-device
data-parallel sharding over `jax.sharding.Mesh`.

Layering (mirrors the reference's layer map, SURVEY.md):
  scenegraph/  — scene-description model + IO      (ref: crates/akari_scenegraph)
  core/        — math, sampling, color, film, rng  (ref: crates/akari_render utils)
  accel/       — BVH build + ray traversal         (ref: LuisaCompute rtx::Accel)
  svm/         — shader graph compiler + BSDFs     (ref: crates/akari_render/src/svm)
  integrators/ — pt / mcmc / gpt / aov             (ref: crates/akari_integrator)
  parallel/    — multi-device sharding             (new; reference is single-device)
"""

import os
from pathlib import Path

__version__ = "0.1.0"

CHECKOUT = Path(__file__).resolve().parent.parent


def cache_dir() -> Path:
    """`<checkout>/.cache`: host-built tables (GGX albedo, rgb2spec, pmj02)
    and, unless JAX_COMPILATION_CACHE_DIR is set, the XLA compile cache."""
    d = CHECKOUT / ".cache"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _enable_compilation_cache():
    """Persistent XLA compilation cache, keyed by HLO hash (code changes
    miss safely). JAX_COMPILATION_CACHE_DIR, when set, is read by JAX
    itself and wins; otherwise the cache lives at `<checkout>/.cache/xla`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(cache_dir() / "xla"))


_enable_compilation_cache()
