"""Film: accumulation + splat buffers with atomic-free scatter-add.

Reference layout (film.rs:66-93): one f32 buffer `[pixels*3 | splat*3 | weight]`.
Array design: the film is a pytree of three arrays; `add_samples` uses XLA
scatter-add (deterministic, no atomics) over flattened pixel indices, which is
the segment-sum replacement for the reference's f32 atomic fetch_add
(film.rs:186-228).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .color import linear_to_srgb, remove_nan


class Film(NamedTuple):
    accum: jnp.ndarray  # [H*W, 3] weighted color sum
    splat: jnp.ndarray  # [H*W, 3] splat sum (MCMC / GPT)
    weight: jnp.ndarray  # [H*W]    filter weight sum
    # static metadata carried out-of-tree
    # (resolution passed separately to stay a clean pytree)

    @staticmethod
    def new(width: int, height: int) -> "Film":
        n = width * height
        return Film(
            accum=jnp.zeros((n, 3), jnp.float32),
            splat=jnp.zeros((n, 3), jnp.float32),
            weight=jnp.zeros((n,), jnp.float32),
        )


def linear_index(p, width: int, height: int):
    """Raster position [..., 2] float -> flat pixel index, with clamping."""
    ip = jnp.floor(p).astype(jnp.int32)
    ix = jnp.clip(ip[..., 0], 0, width - 1)
    iy = jnp.clip(ip[..., 1], 0, height - 1)
    return iy * width + ix


def add_samples(film: Film, p, color, weight, width: int, height: int, mask=None) -> Film:
    """Accumulate filter-weighted samples (ref film.rs add_sample).

    p: [N, 2] raster pos; color: [N, 3]; weight: [N]; mask: [N] bool or None.
    """
    idx = linear_index(p, width, height)
    color = remove_nan(color) * weight[..., None]
    if mask is not None:
        color = jnp.where(mask[..., None], color, 0.0)
        weight = jnp.where(mask, weight, 0.0)
    accum = film.accum.at[idx].add(color, mode="drop")
    w = film.weight.at[idx].add(weight, mode="drop")
    return film._replace(accum=accum, weight=w)


def add_samples_aligned(film: Film, color, weight, mask=None) -> Film:
    """Accumulate when lane i IS pixel i — the reference's actual PT binning
    (pt.rs:1100 adds to the dispatch pixel; the filter jitter perturbs the
    RAY only). Pure elementwise adds — no scatter at all."""
    color = remove_nan(color) * weight[..., None]
    if mask is not None:
        color = jnp.where(mask[..., None], color, 0.0)
        weight = jnp.where(mask, weight, 0.0)
    return film._replace(accum=film.accum + color, weight=film.weight + weight)


def add_splats(film: Film, p, color, weight, width: int, height: int, mask=None) -> Film:
    """Splat (no weight accumulation; scaled by splat_scale at readout)."""
    idx = linear_index(p, width, height)
    color = remove_nan(color) * weight[..., None]
    if mask is not None:
        color = jnp.where(mask[..., None], color, 0.0)
    return film._replace(splat=film.splat.at[idx].add(color, mode="drop"))


def develop(film: Film, width: int, height: int, splat_scale: float = 1.0, srgb: bool = False):
    """Resolve to an [H, W, 3] image: accum/weight + splat*scale (film.rs:120-148)."""
    w = jnp.where(film.weight == 0.0, 1.0, film.weight)
    rgb = film.accum / w[..., None] + film.splat * splat_scale
    if srgb:
        rgb = linear_to_srgb(rgb)
    return rgb.reshape(height, width, 3)
