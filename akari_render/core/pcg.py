"""PCG32 random number generator, batched in uint32/uint64 jnp ops.

Bit-exact PCG-XSH-RR 64/32 (O'Neill), same algorithm as the reference's
device-side Pcg32 (crates/akari_render/src/sampler/mod.rs:73-132) so sampler
behavior is comparable. State is a pytree of two uint64 arrays (state, inc);
all ops broadcast over lanes.

uint64 note: JAX's default x32 config has no uint64, so the 64-bit state is
emulated with two uint32 limbs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_MUL_HI = jnp.uint32(0x5851F42D)  # PCG_DEFAULT_MULTIPLIER 6364136223846793005
_MUL_LO = jnp.uint32(0x4C957F2D)
_INC_HI = jnp.uint32(0x14057B7E)  # PCG_DEFAULT_INCREMENT 1442695040888963407
_INC_LO = jnp.uint32(0xF767814F)


class U64(NamedTuple):
    """Unsigned 64-bit integer as two uint32 limbs (hi, lo)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @staticmethod
    def of(hi, lo):
        return U64(jnp.uint32(hi), jnp.uint32(lo))

    @staticmethod
    def from_u32(x):
        x = jnp.asarray(x, jnp.uint32)
        return U64(jnp.zeros_like(x), x)


def u64_add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(jnp.uint32)
    return U64(a.hi + b.hi + carry, lo)


def u64_mul(a: U64, b: U64) -> U64:
    """Low 64 bits of a*b."""
    a0 = a.lo & jnp.uint32(0xFFFF)
    a1 = a.lo >> 16
    b0 = b.lo & jnp.uint32(0xFFFF)
    b1 = b.lo >> 16
    # lo*lo full 64-bit product via 16-bit limbs
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 16) + (p01 & jnp.uint32(0xFFFF)) + (p10 & jnp.uint32(0xFFFF))
    lo = (p00 & jnp.uint32(0xFFFF)) | (mid << 16)
    lolo_hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    hi = lolo_hi + a.lo * b.hi + a.hi * b.lo
    return U64(hi, lo)


def u64_xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def u64_shr(a: U64, n: int) -> U64:
    if n == 0:
        return a
    if n >= 32:
        return U64(jnp.zeros_like(a.hi), a.hi >> (n - 32) if n > 32 else a.hi)
    return U64(a.hi >> n, (a.lo >> n) | (a.hi << (32 - n)))


def u64_shl(a: U64, n: int) -> U64:
    if n == 0:
        return a
    if n >= 32:
        return U64(a.lo << (n - 32) if n > 32 else a.lo, jnp.zeros_like(a.lo))
    return U64((a.hi << n) | (a.lo >> (32 - n)), a.lo << n)


def u64_or(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


_PCG_MULT = U64.of(0x5851F42D, 0x4C957F2D)
_PCG_INC = U64.of(0x14057B7E, 0xF767814F)


class Pcg32(NamedTuple):
    state: U64
    inc: U64

    @staticmethod
    def new_seq(seq: jnp.ndarray | int, seed: int = 0x853C49E6748FEA9B) -> "Pcg32":
        """pcg32_srandom(seed=default, seq): one generator per lane.

        `seq` is the per-lane stream id (uint32 or U64).
        """
        if not isinstance(seq, U64):
            seq = U64.from_u32(seq)
        seed64 = U64.of((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
        inc = u64_or(u64_shl(seq, 1), U64.of(0, 1))
        # broadcast inc against seed shape
        st = Pcg32(U64(jnp.zeros_like(inc.hi), jnp.zeros_like(inc.lo)), inc)
        st, _ = pcg32_next(st)
        st = Pcg32(u64_add(st.state, seed64), st.inc)
        st, _ = pcg32_next(st)
        return st


def pcg32_next(rng: Pcg32):
    """Advance one step, return (new_state, uint32 output)."""
    old = rng.state
    new_state = u64_add(u64_mul(old, _PCG_MULT), rng.inc)
    xorshifted = u64_shr(u64_xor(u64_shr(old, 18), old), 27).lo
    rot = old.hi >> (59 - 32)
    out = (xorshifted >> rot) | (xorshifted << ((32 - rot) & jnp.uint32(31)))
    return Pcg32(new_state, rng.inc), out


def pcg32_next_f32(rng: Pcg32):
    """Uniform float in [0, 1) with 24 bits of precision."""
    rng, bits = pcg32_next(rng)
    return rng, (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def pcg32_next_2f32(rng: Pcg32):
    rng, a = pcg32_next_f32(rng)
    rng, b = pcg32_next_f32(rng)
    return rng, jnp.stack([a, b], axis=-1)


def pcg32_next_3f32(rng: Pcg32):
    rng, a = pcg32_next_f32(rng)
    rng, b = pcg32_next_f32(rng)
    rng, c = pcg32_next_f32(rng)
    return rng, jnp.stack([a, b, c], axis=-1)
