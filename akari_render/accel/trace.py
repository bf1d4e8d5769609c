"""Ray-scene intersection: batched Möller-Trumbore + dispatch over accel kind.

Replaces LuisaCompute's rtx::Accel (ref scene.rs:42-185) with software
traversal:

- brute force: every ray against every triangle. All intermediates are
  [T, N] with the ray axis minor and per-component scalar arithmetic (no
  [..., 3] vectors); XLA fuses the test into the min-reduction over T. Used
  for small scenes (cbox: 36 tris); big scenes go through clusters
  (accel/cluster.py).
- self-intersection avoidance uses the reference's exclusion-id scheme
  (geometry.rs:18-25): rays carry an excluded triangle id (plus origin
  offsetting, pt.rs:856).

Chunking over T bounds the [chunk, N] temporaries for large scenes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import RAY_TMAX


class Hit(NamedTuple):
    t: jnp.ndarray  # [N] hit distance (RAY_TMAX if miss)
    tri_id: jnp.ndarray  # [N] int32 global triangle id (-1 if miss)
    bary: jnp.ndarray  # [N, 2] barycentric (b1, b2) matching ref convention
    valid: jnp.ndarray  # [N] bool


_CHUNK_T = 512  # triangles per chunk: bounds [chunk, N] temporaries


def _chunk_hits(o, d, tmin, tmax, v0, e1, e2, excludes, tri_base):
    """Möller-Trumbore, all rays x one triangle chunk.

    o, d: [N, 3]; v0/e1/e2: [T, 3]. Returns (t, u, v, hit) each [T, N].
    """
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    v0x, v0y, v0z = v0[:, 0:1], v0[:, 1:2], v0[:, 2:3]  # [T, 1]
    e1x, e1y, e1z = e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]
    e2x, e2y, e2z = e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]

    # pvec = d x e2  -> [T, N]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    # tvec = o - v0
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (qx * dx + qy * dy + qz * dz) * inv_det
    t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    n_chunk = v0.shape[0]
    tri_ids = tri_base + jnp.arange(n_chunk, dtype=jnp.int32)[:, None]
    for ex in excludes:
        if ex is not None:
            hit = hit & (tri_ids != ex)
    return t, u, v, hit


def intersect_brute_force(
    o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None, exclude2=None
) -> Hit:
    """Closest-hit over the full triangle soup (chunked over T)."""
    n = o.shape[0]
    num_tris = v0.shape[0]
    best_t = jnp.minimum(jnp.full((n,), RAY_TMAX, jnp.float32), tmax)
    best_id = jnp.full((n,), -1, jnp.int32)
    best_u = jnp.zeros((n,), jnp.float32)
    best_v = jnp.zeros((n,), jnp.float32)
    exs = [e[None, :] if e is not None else None for e in (exclude0, exclude1, exclude2)]

    for start in range(0, num_tris, _CHUNK_T):
        end = min(start + _CHUNK_T, num_tris)
        t, u, v, hit = _chunk_hits(
            o, d, tmin, best_t, v0[start:end], e1[start:end], e2[start:end],
            exs, jnp.int32(start),
        )
        t_m = jnp.where(hit, t, RAY_TMAX)
        am = jnp.argmin(t_m, axis=0)  # [N]
        sel = jnp.arange(end - start, dtype=jnp.int32)[:, None] == am[None, :]
        ct = jnp.min(t_m, axis=0)
        cu = jnp.sum(jnp.where(sel, u, 0.0), axis=0)
        cv = jnp.sum(jnp.where(sel, v, 0.0), axis=0)
        chit = jnp.any(hit, axis=0)
        better = chit & (ct < best_t)
        best_t = jnp.where(better, ct, best_t)
        best_id = jnp.where(better, jnp.int32(start) + am.astype(jnp.int32), best_id)
        best_u = jnp.where(better, cu, best_u)
        best_v = jnp.where(better, cv, best_v)

    return Hit(
        t=best_t,
        tri_id=best_id,
        bary=jnp.stack([best_u, best_v], axis=-1),
        valid=best_id >= 0,
    )


def occlude_brute_force(o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None,
                        exclude2=None):
    """Any-hit: returns bool [N] (True = occluded)."""
    n = o.shape[0]
    num_tris = v0.shape[0]
    occluded = jnp.zeros((n,), bool)
    exs = [e[None, :] if e is not None else None for e in (exclude0, exclude1, exclude2)]
    for start in range(0, num_tris, _CHUNK_T):
        end = min(start + _CHUNK_T, num_tris)
        _, _, _, hit = _chunk_hits(
            o, d, tmin, tmax, v0[start:end], e1[start:end], e2[start:end],
            exs, jnp.int32(start),
        )
        occluded = occluded | jnp.any(hit, axis=0)
    return occluded
