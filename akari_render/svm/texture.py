"""Texture sampling: atlas of 2D images + procedural noise.

Array replacement for LuisaCompute BindlessArray tex2d sampling
(ref heap.rs bind_tex2d + eval.rs RgbImageTex): all images live in one
[n_layers, H, W, 4] padded array; sampling is manual bilinear with
address-mode index math — plain XLA gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class TextureAtlas(NamedTuple):
    data: jnp.ndarray  # [L, H, W, 4] float32 (all images padded to max size)
    sizes: jnp.ndarray  # [L, 2] (width, height) actual sizes

    @staticmethod
    def build(images: list[np.ndarray]) -> "TextureAtlas":
        """images: list of [h, w, 4] float32 arrays (already linearized where
        needed happens at sample time for 8-bit srgb — we store raw values)."""
        if not images:
            images = [np.zeros((1, 1, 4), np.float32)]
        mh = max(im.shape[0] for im in images)
        mw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), mh, mw, 4), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            data[i, :h, :w] = im
            sizes[i] = (w, h)
        return TextureAtlas(jnp.asarray(data), jnp.asarray(sizes))


def _address(i, n, mode: str):
    if mode == "repeat":
        return jnp.mod(i, n)
    if mode == "mirror":
        period = 2 * n
        j = jnp.mod(i, period)
        return jnp.where(j >= n, period - 1 - j, j)
    if mode == "extend":
        return jnp.clip(i, 0, n - 1)
    # 'clip' handled by caller (zero outside)
    return jnp.clip(i, 0, n - 1)


def sample_texture(atlas: TextureAtlas | None, layer, uv, extension: str, interpolation: str):
    """Bilinear/nearest sample [N] layers at [N, 2] uvs -> [N, 4].

    v axis: images are stored flipped (load.rs:599 flipv) so v=0 is the
    bottom — we flip at load time instead and sample directly.
    """
    if atlas is None:
        return jnp.ones(uv.shape[:-1] + (4,))
    w = atlas.sizes[layer, 0].astype(jnp.float32)
    h = atlas.sizes[layer, 1].astype(jnp.float32)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    wi_ = atlas.sizes[layer, 0]
    hi_ = atlas.sizes[layer, 1]

    def fetch(ix, iy):
        cx = _address(ix, wi_, extension)
        cy = _address(iy, hi_, extension)
        val = atlas.data[layer, cy, cx]
        if extension == "clip":
            inside = (ix >= 0) & (ix < wi_) & (iy >= 0) & (iy < hi_)
            val = jnp.where(inside[..., None], val, 0.0)
        return val

    if interpolation == "nearest":
        return fetch(jnp.round(x).astype(jnp.int32), jnp.round(y).astype(jnp.int32))
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


# ---- Perlin noise, Blender-compatible 1-4D ----------------------------------
# Hashing is Jenkins lookup3 exactly as Blender / the reference use it
# (ref util/hash.rs:93-185 blender::hash_uint{,2,3,4}); gradients and the
# per-dimension output scaling follow Blender's noise.cc perlin_signed
# (the reference's perlin.rs:16-65 covers 1D/2D with the same grad1/grad2;
# 3D/4D are net-new here — the reference never implemented them).
_U32 = jnp.uint32


def _rot(x, k):
    return (x << _U32(k)) | (x >> _U32(32 - k))


def _jenkins_final(a, b, c):
    c ^= b
    c -= _rot(b, 14)
    a ^= c
    a -= _rot(c, 11)
    b ^= a
    b -= _rot(a, 25)
    c ^= b
    c -= _rot(b, 16)
    a ^= c
    a -= _rot(c, 4)
    b ^= a
    b -= _rot(a, 14)
    c ^= b
    c -= _rot(b, 24)
    return a, b, c


def _jenkins_mix(a, b, c):
    a -= c
    a ^= _rot(c, 4)
    c += b
    b -= a
    b ^= _rot(a, 6)
    a += c
    c -= b
    c ^= _rot(b, 8)
    b += a
    a -= c
    a ^= _rot(c, 16)
    c += b
    b -= a
    b ^= _rot(a, 19)
    a += c
    c -= b
    c ^= _rot(b, 4)
    b += a
    return a, b, c


def _hash_uint(kx):
    init = _U32(0xDEADBEEF + (1 << 2) + 13)
    a = init + kx
    _, _, c = _jenkins_final(a, jnp.full_like(kx, init), jnp.full_like(kx, init))
    return c


def _hash_uint2(kx, ky):
    init = _U32(0xDEADBEEF + (2 << 2) + 13)
    # note: the reference adds y into a and x into b (hash.rs:143-155)
    a = init + ky
    b = init + kx
    _, _, c = _jenkins_final(a, b, jnp.full_like(kx, init))
    return c


def _hash_uint3(kx, ky, kz):
    init = _U32(0xDEADBEEF + (3 << 2) + 13)
    _, _, c = _jenkins_final(init + kx, init + ky, init + kz)
    return c


def _hash_uint4(kx, ky, kz, kw):
    init = _U32(0xDEADBEEF + (4 << 2) + 13)
    a, b, c = _jenkins_mix(init + kx, init + ky, init + kz)
    a += kw
    _, _, c = _jenkins_final(a, b, c)
    return c


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _negate_if(v, cond):
    return jnp.where(cond, -v, v)


def _grad1(h, x):
    hh = h & _U32(15)
    g = 1.0 + (hh & _U32(7)).astype(jnp.float32)
    return _negate_if(g, (hh & _U32(8)) != 0) * x


def _grad2(h, x, y):
    hh = h & _U32(7)
    u = jnp.where(hh < 4, x, y)
    v = 2.0 * jnp.where(hh < 4, y, x)
    return _negate_if(u, (hh & _U32(1)) != 0) + _negate_if(v, (hh & _U32(2)) != 0)


def _grad3(h, x, y, z):
    hh = h & _U32(15)
    u = jnp.where(hh < 8, x, y)
    vt = jnp.where((hh == 12) | (hh == 14), x, z)
    v = jnp.where(hh < 4, y, vt)
    return _negate_if(u, (hh & _U32(1)) != 0) + _negate_if(v, (hh & _U32(2)) != 0)


def _grad4(h, x, y, z, w):
    hh = h & _U32(31)
    u = jnp.where(hh < 24, x, y)
    v = jnp.where(hh < 16, y, z)
    s = jnp.where(hh < 8, z, w)
    return (
        _negate_if(u, (hh & _U32(1)) != 0)
        + _negate_if(v, (hh & _U32(2)) != 0)
        + _negate_if(s, (hh & _U32(4)) != 0)
    )


def _floor_split(x):
    i = jnp.floor(x)
    return i.astype(jnp.int32).astype(jnp.uint32), x - i


def perlin_noise(p, dim: int = 2):
    """Blender-compatible Perlin noise in [0, 1]. p: [..., dim]."""
    if dim == 1:
        xi, xf = _floor_split(p[..., 0])
        u = _fade(xf)
        n0 = _grad1(_hash_uint(xi), xf)
        n1 = _grad1(_hash_uint(xi + _U32(1)), xf - 1.0)
        s = (n0 * (1 - u) + n1 * u) * 0.2500
    elif dim == 2:
        xi, xf = _floor_split(p[..., 0])
        yi, yf = _floor_split(p[..., 1])
        u, v = _fade(xf), _fade(yf)
        corners = []
        for cy in (0, 1):
            for cx in (0, 1):
                h = _hash_uint2(xi + _U32(cx), yi + _U32(cy))
                corners.append(_grad2(h, xf - cx, yf - cy))
        nx0 = corners[0] * (1 - u) + corners[1] * u
        nx1 = corners[2] * (1 - u) + corners[3] * u
        s = (nx0 * (1 - v) + nx1 * v) * 0.6616
    elif dim == 3:
        xi, xf = _floor_split(p[..., 0])
        yi, yf = _floor_split(p[..., 1])
        zi, zf = _floor_split(p[..., 2])
        u, v, w = _fade(xf), _fade(yf), _fade(zf)
        vals = []
        for cz in (0, 1):
            for cy in (0, 1):
                for cx in (0, 1):
                    h = _hash_uint3(xi + _U32(cx), yi + _U32(cy), zi + _U32(cz))
                    vals.append(_grad3(h, xf - cx, yf - cy, zf - cz))
        def lerp(a, b, t):
            return a * (1 - t) + b * t
        x00 = lerp(vals[0], vals[1], u)
        x10 = lerp(vals[2], vals[3], u)
        x01 = lerp(vals[4], vals[5], u)
        x11 = lerp(vals[6], vals[7], u)
        y0 = lerp(x00, x10, v)
        y1 = lerp(x01, x11, v)
        s = lerp(y0, y1, w) * 0.9820
    elif dim == 4:
        xi, xf = _floor_split(p[..., 0])
        yi, yf = _floor_split(p[..., 1])
        zi, zf = _floor_split(p[..., 2])
        wi, wf = _floor_split(p[..., 3])
        u, v, w, q = _fade(xf), _fade(yf), _fade(zf), _fade(wf)
        vals = []
        for cw in (0, 1):
            for cz in (0, 1):
                for cy in (0, 1):
                    for cx in (0, 1):
                        h = _hash_uint4(
                            xi + _U32(cx), yi + _U32(cy), zi + _U32(cz), wi + _U32(cw)
                        )
                        vals.append(_grad4(h, xf - cx, yf - cy, zf - cz, wf - cw))
        def lerp(a, b, t):
            return a * (1 - t) + b * t
        out = vals
        for tdim, t in ((1, u), (2, v), (4, w), (8, q)):
            out = [lerp(out[i], out[i + 1], t) for i in range(0, len(out), 2)]
        s = out[0] * 0.8344
    else:
        raise ValueError(f"perlin dim {dim} unsupported (1-4)")
    return s * 0.5 + 0.5
