"""Samplers: per-lane random streams for the wavefront integrators.

Reference: crates/akari_render/src/sampler/mod.rs — `Sampler` trait with
IndependentSampler (PCG32, 16384-dim stride per sample) and Pmj02BnSampler.
Array design: a sampler is a pytree of per-lane state plus pure functions; the
integrator threads the state through `lax.scan`/unrolled bounce loops.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .pcg import (
    Pcg32,
    U64,
    pcg32_next,
    pcg32_next_f32,
    u64_add,
    u64_mul,
    u64_xor,
    u64_shl,
)


def _hash_u64(hi, lo):
    """Mix two uint32s into well-distributed uint32 (splitmix-ish)."""
    x = lo ^ (hi * jnp.uint32(0x9E3779B9))
    x ^= x >> 16
    x *= jnp.uint32(0x85EBCA6B)
    x ^= x >> 13
    x *= jnp.uint32(0xC2B2AE35)
    x ^= x >> 16
    return x


class IndependentSampler(NamedTuple):
    """One PCG32 stream per lane.

    Per-lane stream id = hash(pixel_id, seed); per-sample decorrelation comes
    from consuming the stream (matches reference behavior statistically; the
    reference's state-buffer round-trips are unnecessary here since the whole
    sample loop lives in one traced program).
    """

    rng: Pcg32

    @staticmethod
    def new(lane_ids, seed: int = 0) -> "IndependentSampler":
        lane_ids = jnp.asarray(lane_ids, jnp.uint32)
        seq = _hash_u64(jnp.uint32(seed), lane_ids)
        return IndependentSampler(Pcg32.new_seq(U64(lane_ids, seq)))

    def next_1d(self):
        rng, u = pcg32_next_f32(self.rng)
        return IndependentSampler(rng), u

    def next_2d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        return s, jnp.stack([a, b], axis=-1)

    def next_3d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        s, c = s.next_1d()
        return s, jnp.stack([a, b, c], axis=-1)


class HashSampler(NamedTuple):
    """Stateless counter-based RNG: u_i = finalize(key, dim_counter).

    Perf alternative to IndependentSampler (AKR_RNG=hash): PCG32's emulated
    64-bit step costs ~20 uint32 ops per drawn dimension. The counter-based form (Salmon et
    al., "Parallel random numbers: as easy as 1, 2, 3", SC'11 - the
    philox/threefry idea at hash strength) needs one carried uint32 and ~9
    ops per dim. Streams are keyed (pixel, sample_index, seed) exactly like
    IndependentSampler, and per-dimension values come from a strong 2-round
    integer finalizer (lowbias32-style avalanche), so draws are i.i.d.
    uniform to float32 precision - same estimator, different (still white)
    noise. NOT bit-compatible with the reference's Pcg32: opt-in.
    """

    key: jnp.ndarray  # [N] uint32 per-lane stream key
    ctr: jnp.ndarray  # [N] uint32 dimension counter

    @staticmethod
    def new(lane_ids, seed: int = 0) -> "HashSampler":
        lane_ids = jnp.asarray(lane_ids, jnp.uint32)
        key = _hash_u64(jnp.uint32(seed), lane_ids)
        return HashSampler(key, jnp.zeros_like(lane_ids))

    def next_1d(self):
        x = self.key ^ (self.ctr * jnp.uint32(0x9E3779B9))
        x ^= x >> 16
        x *= jnp.uint32(0x21F0AAAD)
        x ^= x >> 15
        x *= jnp.uint32(0x735A2D97)
        x ^= x >> 15
        u = (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
        return HashSampler(self.key, self.ctr + 1), u

    def next_2d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        return s, jnp.stack([a, b], axis=-1)

    def next_3d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        s, c = s.next_1d()
        return s, jnp.stack([a, b, c], axis=-1)
