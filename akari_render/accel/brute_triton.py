"""Brute-force Möller-Trumbore as a Pallas kernel for the GPU (Triton route).

One program holds a block of BN rays in registers and loops over the
triangle soup in chunks of TC triangles, keeping the best hit per ray in
the loop carry: the [T, N] intermediates of accel/trace.py never exist.
Same results as intersect_brute_force: exclusion ids, first triangle wins
a tie in t, and a miss reports t = min(tmax, RAY_TMAX).

`intersect_brute` / `occlude_brute` are what the scene calls: the kernel
on a CUDA GPU, XLA's fused brute force on every other platform (the CPU
tests). That is the package's one platform decision, made by
`lax.platform_dependent` when the pass is lowered. Measured on an H100
at a 400 W limit (PERF.md): 17% more cbox paths per second end to end.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.math import RAY_TMAX
from .trace import Hit, intersect_brute_force, occlude_brute_force

_TMAX = float(RAY_TMAX)
# rays per program, triangles per loop step, warps per program: the best of
# four block shapes timed on an H100 for cbox and matbox (PERF.md)
BN, TC, NUM_WARPS = 128, 16, 4


def _kernel(*refs, n_chunks, tc, any_hit):
    (ox, oy, oz, dx, dy, dz, tmin_r, tmax_r, ex0, ex1, ex2) = refs[:11]
    tris = refs[11:20]
    outs = refs[20:]
    ox, oy, oz = ox[...][:, None], oy[...][:, None], oz[...][:, None]
    dx, dy, dz = dx[...][:, None], dy[...][:, None], dz[...][:, None]
    tmin = tmin_r[...][:, None]
    exs = (ex0[...][:, None], ex1[...][:, None], ex2[...][:, None])
    bn = ox.shape[0]
    lane_ids = jax.lax.broadcasted_iota(jnp.int32, (1, tc), 1)

    def body(c, carry):
        best_t = carry[0]
        sl = pl.ds(c * tc, tc)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            r[sl][None, :] for r in tris
        )
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (qx * dx + qy * dy + qz * dz) * inv_det
        t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
        ids = c * tc + lane_ids
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
               & (t < best_t[:, None]))
        for ex in exs:
            hit = hit & (ids != ex)
        if any_hit:
            return (best_t, carry[1] | jnp.max(hit.astype(jnp.int32), axis=1))
        t_m = jnp.where(hit, t, _TMAX)
        ct = jnp.min(t_m, axis=1)
        first = jnp.min(
            jnp.where(hit & (t_m == ct[:, None]), ids, jnp.int32(2**30)), axis=1
        )
        sel = ids == first[:, None]
        better = ct < best_t
        return (
            jnp.where(better, ct, best_t),
            jnp.where(better, first, carry[1]),
            jnp.where(better, jnp.sum(jnp.where(sel, u, 0.0), axis=1), carry[2]),
            jnp.where(better, jnp.sum(jnp.where(sel, v, 0.0), axis=1), carry[3]),
        )

    best_t = jnp.minimum(tmax_r[...], _TMAX)
    if any_hit:
        init = (best_t, jnp.zeros((bn,), jnp.int32))
    else:
        init = (best_t, jnp.full((bn,), -1, jnp.int32),
                jnp.zeros((bn,), jnp.float32), jnp.zeros((bn,), jnp.float32))
    res = jax.lax.fori_loop(0, n_chunks, body, init)
    if any_hit:
        outs[0][...] = res[1]
    else:
        for ref, val in zip(outs, res):
            ref[...] = val


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def intersect_brute_triton(o, d, tmin, tmax, v0, e1, e2, exclude0=None,
                           exclude1=None, exclude2=None, any_hit=False,
                           interpret=False):
    """Closest hit (Hit) or, with any_hit, occlusion (bool [N])."""
    bn, tc = BN, TC
    n = o.shape[0]
    npad = -(-n // bn) * bn
    num_tris = v0.shape[0]
    tpad = -(-num_tris // tc) * tc

    def pad_rays(x, fill):
        return jnp.pad(x, (0, npad - n), constant_values=fill)

    none = jnp.full((n,), -1, jnp.int32)
    rays = [pad_rays(o[:, k].astype(jnp.float32), 0.0) for k in range(3)]
    rays += [pad_rays(d[:, k].astype(jnp.float32), 1.0) for k in range(3)]
    rays += [pad_rays(tmin.astype(jnp.float32), 0.0),
             pad_rays(tmax.astype(jnp.float32), -1.0)]
    rays += [pad_rays((none if e is None else e.astype(jnp.int32)), -1)
             for e in (exclude0, exclude1, exclude2)]
    # zero padding triangles are degenerate (det = 0): they never hit
    tris = [jnp.pad(a[:, k].astype(jnp.float32), (0, tpad - num_tris))
            for a in (v0, e1, e2) for k in range(3)]

    ray_spec = pl.BlockSpec((bn,), lambda i: (i,))
    tri_spec = pl.BlockSpec((tpad,), lambda i: (0,))
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((npad,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((npad,), jnp.float32),
                     jax.ShapeDtypeStruct((npad,), jnp.int32),
                     jax.ShapeDtypeStruct((npad,), jnp.float32),
                     jax.ShapeDtypeStruct((npad,), jnp.float32)]
    outs = pl.pallas_call(
        functools.partial(_kernel, n_chunks=tpad // tc, tc=tc, any_hit=any_hit),
        grid=(npad // bn,),
        in_specs=[ray_spec] * 11 + [tri_spec] * 9,
        out_specs=[ray_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="brute_mt_any" if any_hit else "brute_mt",
    )(*rays, *tris)
    if any_hit:
        return outs[0][:n] > 0
    t, tri_id, u, v = (x[:n] for x in outs)
    return Hit(t=t, tri_id=tri_id, bary=jnp.stack([u, v], -1), valid=tri_id >= 0)


def intersect_brute(o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None,
                    exclude2=None) -> Hit:
    """Closest hit over the whole triangle soup."""
    return jax.lax.platform_dependent(
        o, d, tmin, tmax, v0, e1, e2, exclude0, exclude1, exclude2,
        cuda=intersect_brute_triton, default=intersect_brute_force,
    )


def occlude_brute(o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None,
                  exclude2=None):
    """Any hit over the whole triangle soup: bool [N]."""
    return jax.lax.platform_dependent(
        o, d, tmin, tmax, v0, e1, e2, exclude0, exclude1, exclude2,
        cuda=functools.partial(intersect_brute_triton, any_hit=True),
        default=occlude_brute_force,
    )
