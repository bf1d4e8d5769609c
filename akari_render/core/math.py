"""Batched 3D math primitives.

Vectors are jnp arrays of shape [..., 3]; all functions broadcast over leading
(lane) axes so the whole renderer is written "wavefront-style": one call
operates on an entire ray batch, which is what XLA wants.

Reference semantics: crates/akari_render/src/geometry.rs (Frame, reflect,
refract, face_forward, offset_ray_origin via LuisaCompute rtx).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

F32_MAX = jnp.float32(3.4028235e38)
RAY_TMAX = jnp.float32(1e20)
INVALID_ID = jnp.uint32(0xFFFFFFFF)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def length_squared(v):
    return dot(v, v)


def normalize(v):
    return v * jax.lax.rsqrt(jnp.maximum(dot(v, v), 1e-30))[..., None]


def face_forward(v, ref):
    """Flip v so that it lies in the hemisphere of ref (ref: geometry.rs face_forward)."""
    return jnp.where(dot(v, ref)[..., None] < 0.0, -v, v)


def reflect(w, n):
    """Mirror w about n. Both unit; w points away from surface (local shading conv)."""
    return -w + 2.0 * dot(w, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta = eta_t / eta_i.

    Returns (refracted_mask, eta_eff, wt). Follows geometry.rs:276-313 semantics:
    handles rays hitting from either side (flips n / inverts eta internally).
    """
    cos_i = dot(wi, n)
    entering = cos_i > 0.0
    eta_eff = jnp.where(entering, eta, 1.0 / eta)
    n_eff = jnp.where(entering[..., None], n, -n)
    cos_i = jnp.abs(cos_i)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = sin2_i / (eta_eff * eta_eff)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = (-wi) / eta_eff[..., None] + (cos_i / eta_eff - cos_t)[..., None] * n_eff
    return ~tir, eta_eff, wt


# --- Watertight-ish ray origin offsetting (Ray Tracing Gems ch.6) -----------
_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def offset_ray_origin(p, n):
    """Offset ray origin along geometric normal to avoid self-intersection.

    Same algorithm LuisaCompute's rtx::offset_ray_origin uses (Ray Tracing
    Gems, "A Fast and Robust Method for Avoiding Self-Intersection").
    """
    of_i = (_INT_SCALE * n).astype(jnp.int32)
    ip = jax.lax.bitcast_convert_type(p, jnp.int32)
    ip_off = ip + jnp.where(p < 0.0, -of_i, of_i)
    p_i = jax.lax.bitcast_convert_type(ip_off, jnp.float32)
    return jnp.where(
        jnp.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i
    )


# --- Orthonormal frame -------------------------------------------------------
def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017), batched.

    Returns (t, b) with [t, b, n] right-handed orthonormal.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    bv = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * bv, -sign * n[..., 0]],
        axis=-1,
    )
    b = jnp.stack([bv, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, b


class Frame:
    """TBN frame helpers operating on stacked (t, b, n) arrays [..., 3].

    Local convention (matches ref geometry.rs Frame): +z is the normal.
    """

    @staticmethod
    def from_normal(n):
        t, b = orthonormal_basis(n)
        return t, b, n

    @staticmethod
    def to_local(t, b, n, v):
        return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)

    @staticmethod
    def to_world(t, b, n, v):
        return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n

    # trig helpers on local vectors
    @staticmethod
    def cos_theta(w):
        return w[..., 2]

    @staticmethod
    def abs_cos_theta(w):
        return jnp.abs(w[..., 2])

    @staticmethod
    def cos2_theta(w):
        return w[..., 2] * w[..., 2]

    @staticmethod
    def sin2_theta(w):
        return jnp.maximum(0.0, 1.0 - w[..., 2] * w[..., 2])

    @staticmethod
    def sin_theta(w):
        return jnp.sqrt(Frame.sin2_theta(w))

    @staticmethod
    def tan_theta(w):
        return Frame.sin_theta(w) / w[..., 2]

    @staticmethod
    def tan2_theta(w):
        return Frame.sin2_theta(w) / jnp.maximum(Frame.cos2_theta(w), 1e-30)

    @staticmethod
    def cos_phi(w):
        s = Frame.sin_theta(w)
        return jnp.where(s == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.maximum(s, 1e-30), -1.0, 1.0))

    @staticmethod
    def sin_phi(w):
        s = Frame.sin_theta(w)
        return jnp.where(s == 0.0, 0.0, jnp.clip(w[..., 1] / jnp.maximum(s, 1e-30), -1.0, 1.0))

    @staticmethod
    def cos2_phi(w):
        c = Frame.cos_phi(w)
        return c * c

    @staticmethod
    def sin2_phi(w):
        s = Frame.sin_phi(w)
        return s * s

    @staticmethod
    def same_hemisphere(a, b):
        return a[..., 2] * b[..., 2] > 0.0


# --- Affine transforms -------------------------------------------------------
# Every f32 contraction on the render path asks for full f32: a default-
# precision f32 matmul may run in TF32 on the GPU (about three decimal
# digits), which quantizes ray directions/positions (terraced silhouettes).
HIGHEST = jax.lax.Precision.HIGHEST


def transform_point(m, p):
    """Apply 4x4 matrix [..., 4, 4] (or [4,4]) to points [..., 3]."""
    r = jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=HIGHEST) + m[..., :3, 3]
    return r


def transform_vector(m, v):
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v, precision=HIGHEST)


def transform_normal(m_inv, n):
    """Normals transform by inverse-transpose: pass the INVERSE matrix here."""
    return jnp.einsum("...ji,...j->...i", m_inv[..., :3, :3], n, precision=HIGHEST)


def difference_of_products(a, b, c, d):
    """a*b - c*d with error compensation (ref util/mod.rs:326-331).

    f32 fma is not exposed through jnp, so this relies on XLA emitting fused
    multiply-adds for the `a * b - cd` form, which recovers most of the
    cancellation error.
    """
    cd = c * d
    return a * b - cd


def lerp(a, b, t):
    return a + (b - a) * t
