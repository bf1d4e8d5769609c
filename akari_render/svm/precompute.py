"""Precomputed BSDF albedo tables (GGX dielectric directional albedo).

Reference: crates/akari_render/src/svm/surface/precompute.rs — a 16^3 table
over (roughness, mu=cos_theta, z) with ior = ior_from_f0(z^4), each cell an
MC estimate of E[f/pdf] for a GGX+dielectric-Fresnel reflection lobe; cached
to disk next to the executable. Here: one jitted MC batch, cached as .npy
under `<checkout>/.cache`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import cache_dir
from ..core.math import HIGHEST, Frame
from .microfacet import TrowbridgeReitz, fr_dielectric, ior_from_f0

DIM = 16
_SAMPLES = 1 << 14

_cache: dict[str, jnp.ndarray] = {}


def _compute_ggx_dielectric_table() -> np.ndarray:
    """Directional albedo of GGX reflection with dielectric Fresnel."""
    grid = np.clip(np.arange(DIM) / (DIM - 1.0), 1e-4, 0.9999)
    rough, mu, z = np.meshgrid(grid, grid, grid, indexing="ij")
    rough = jnp.asarray(rough.ravel(), jnp.float32)
    mu = jnp.asarray(mu.ravel(), jnp.float32)
    ior = ior_from_f0(jnp.asarray(z.ravel(), jnp.float32) ** 4)

    n_cells = rough.shape[0]

    @jax.jit
    def one_round(key):
        u = jax.random.uniform(key, (n_cells, 2))
        dist = TrowbridgeReitz.from_roughness(rough, sample_visible=True)
        wo = jnp.stack([jnp.sqrt(jnp.maximum(0.0, 1.0 - mu * mu)), jnp.zeros_like(mu), mu], -1)
        wh = dist.sample_wh(wo, u)
        wi = -wo + 2.0 * jnp.sum(wo * wh, -1, keepdims=True) * wh
        valid = Frame.same_hemisphere(wo, wi)
        # f/pdf for the VNDF estimator of MicrofacetReflection:
        # f = F D G / (4 cos_o cos_i) * cos_i ; pdf = D G1 |wo.wh| / cos_o / (4 |wo.wh|)
        fr = fr_dielectric(jnp.sum(wi * wh, -1), ior)
        d = dist.d(wh)
        g = dist.g(wo, wi)
        cos_o = Frame.cos_theta(wo)
        cos_i = Frame.cos_theta(wi)
        f = fr * jnp.abs(0.25 * d * g / jnp.maximum(jnp.abs(cos_o * cos_i), 1e-12)) * jnp.abs(cos_i)
        pdf = dist.pdf(wo, wh) / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-12)
        val = jnp.where(valid & (pdf > 0.0), f / jnp.maximum(pdf, 1e-20), 0.0)
        return val

    per_batch = 2048  # samples per cell per jit call
    n_batches = max(1, _SAMPLES // per_batch)

    batched = jax.jit(lambda key: jax.vmap(one_round)(jax.random.split(key, per_batch)).sum(0))
    acc = np.zeros(n_cells, np.float64)
    key = jax.random.PRNGKey(0)
    for i in range(n_batches):
        acc += np.asarray(batched(jax.random.fold_in(key, i)), np.float64)
    return (acc / (n_batches * per_batch)).astype(np.float32).reshape(DIM, DIM, DIM)


def get_table(name: str = "ggx_dielectric_s") -> jnp.ndarray:
    # cache NUMPY arrays (never traced values) — converting inside a trace
    # must produce a fresh constant each time or tracers leak via the cache
    if name not in _cache:
        path = cache_dir() / f"{name}.{DIM}.npy"
        if path.exists():
            tbl = np.load(path)
        else:
            assert name == "ggx_dielectric_s", name
            tbl = _compute_ggx_dielectric_table()
            np.save(path, tbl)
        _cache[name] = np.asarray(tbl)
    return jnp.asarray(_cache[name])


def _lerp_weights(c, size):
    """[N] coord in [0,1] -> [N, size] trilinear weight vector (2 nonzeros)."""
    c = jnp.clip(c, 0.0, 1.0) * (size - 1.0)
    i0 = jnp.floor(c).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, size - 1)
    t = c - i0.astype(jnp.float32)
    cols = jax.lax.broadcasted_iota(jnp.int32, c.shape + (size,), c.ndim)
    w = jnp.where(cols == i0[..., None], 1.0 - t[..., None], 0.0)
    w = jnp.where(cols == i1[..., None], w + t[..., None], w)
    return w


def read_3d(table, x, y, z):
    """Trilinear lookup matching the reference's read_3d (mod.rs:1212-1262),
    implemented gather-free as a factorized tensor contraction.

    At 1M lanes this costs 8.4 GFLOP + a [N, X*Y] intermediate per call,
    so hot closures avoid per-query read_3d entirely: the (x, z) axes are
    view-independent, so they hoist a cos curve once per closure
    (albedo_curve/curve_eval below) and pay ~100 flops per query. read_3d
    stays as the general/reference-exact form."""
    X, Y, Z = table.shape
    wx = _lerp_weights(x, X)  # [N, X]
    wy = _lerp_weights(y, Y)
    wz = _lerp_weights(z, Z)
    # contract z as one matmul: [N, Z] @ [Z, X*Y] -> [N, X, Y]
    t2 = jnp.matmul(wz, table.reshape(X * Y, Z).T, precision=HIGHEST)
    t2 = t2.reshape(wz.shape[:-1] + (X, Y))
    t1 = jnp.einsum("...xy,...y->...x", t2, wy, precision=HIGHEST)
    return jnp.einsum("...x,...x->...", t1, wx, precision=HIGHEST)


def albedo_curve(table, x, z):
    """Contract the [X, Y, Z] table over its view-INDEPENDENT axes
    (x = roughness, z = f0-ish eta parameter) -> per-lane cos curve [..., Y].

    Closures call this ONCE at construction (x/z never depend on wo/wi) and
    evaluate each directional-albedo query with curve_eval — replacing 4-6
    full read_3d contractions per shade dispatch with one."""
    X, Y, Z = table.shape
    wx = _lerp_weights(x, X)  # [N, X]
    wz = _lerp_weights(z, Z)  # [N, Z]
    # [N, Z] @ [Z, X*Y] -> [N, X, Y], then weight-sum over X -> [N, Y]
    t2 = jnp.matmul(wz, table.reshape(X * Y, Z).T, precision=HIGHEST)
    t2 = t2.reshape(wz.shape[:-1] + (X, Y))
    return jnp.einsum("...xy,...x->...y", t2, wx, precision=HIGHEST)


def albedo_curve_np(x: float, z: float, name: str = "ggx_dielectric_s"):
    """Static-constant fast path: numpy bilinear contraction at trace time.
    Returns a [Y] numpy curve — a free constant in the compiled graph."""
    get_table(name)  # populate the cache
    tbl = _cache[name]  # raw NUMPY view (get_table's return is traced in jit)
    X, Y, Z = tbl.shape

    def prep(v, s):
        vf = float(np.clip(v, 0.0, 1.0)) * (s - 1.0)
        i0 = int(np.clip(np.floor(vf), 0, s - 1))
        i1 = min(i0 + 1, s - 1)
        return i0, i1, vf - i0

    x0, x1, fx = prep(x, X)
    z0, z1, fz = prep(z, Z)
    c0 = tbl[x0, :, z0] * (1 - fz) + tbl[x0, :, z1] * fz
    c1 = tbl[x1, :, z0] * (1 - fz) + tbl[x1, :, z1] * fz
    return c0 * (1 - fx) + c1 * fx


def curve_eval(curve, cos_y):
    """Piecewise-linear eval of a [Y]- or [..., Y]-knot curve at cos_y [...].

    Matches read_3d's interpolation on the cos axis exactly (trilinear
    factorizes per axis); built from a 2-nonzero weight vector contracted
    elementwise — no gathers (~100 flops/lane for Y=16)."""
    Y = curve.shape[-1]
    w = _lerp_weights(cos_y, Y)  # [..., Y]
    return jnp.sum(curve * w, axis=-1)


def ggx_dielectric_albedo(table, roughness, cos_theta_i, eta):
    """surface/mod.rs:1144-1154."""
    z = jnp.sqrt(jnp.abs((eta - 1.0) / (eta + 1.0)))
    c = jnp.abs(jnp.clip(cos_theta_i, -0.999, 0.999))
    return read_3d(table, roughness, c, z)
