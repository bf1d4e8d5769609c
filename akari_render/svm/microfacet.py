"""Trowbridge-Reitz (GGX) microfacet distribution, batched.

Reference: crates/akari_render/src/microfacet.rs (d / lambda / g1 / g /
sample_wh VNDF + non-visible variant with analytic inverse for MCMC replay,
pdf). Local shading space: +z = normal.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import Frame, face_forward, normalize
from ..core.sampling import INV_2PI, PI, TWO_PI, uniform_sample_disk

MIN_ALPHA = 1e-4


class TrowbridgeReitz(NamedTuple):
    alpha: jnp.ndarray  # [..., 2] anisotropic alphas
    sample_visible: bool = True

    @staticmethod
    def from_roughness(roughness, sample_visible: bool = True) -> "TrowbridgeReitz":
        """roughness: [...] or [..., 2]; alpha = roughness^2 (microfacet.rs:39-42)."""
        r = jnp.asarray(roughness)
        if r.ndim == 0 or r.shape[-1] != 2:
            r = jnp.stack([r, r], axis=-1)
        return TrowbridgeReitz(jnp.maximum(r * r, MIN_ALPHA), sample_visible)

    @property
    def roughness(self):
        return jnp.sqrt(jnp.sum(self.alpha, axis=-1) * 0.5)

    def d(self, wh):
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        tan2 = Frame.tan2_theta(wh)
        cos4 = Frame.cos2_theta(wh) ** 2
        e = tan2 * ((Frame.cos_phi(wh) / ax) ** 2 + (Frame.sin_phi(wh) / ay) ** 2)
        inv_d = PI * ax * ay * cos4 * (1.0 + e) ** 2
        bad = ~jnp.isfinite(tan2) | ~jnp.isfinite(inv_d) | (inv_d == 0.0)
        return jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, inv_d))

    def lambda_(self, w):
        abs_tan = jnp.abs(Frame.tan_theta(w))
        a2 = Frame.cos2_phi(w) * self.alpha[..., 0] ** 2 + Frame.sin2_phi(w) * self.alpha[..., 1] ** 2
        l = (-1.0 + jnp.sqrt(1.0 + a2 * abs_tan**2)) * 0.5
        return jnp.where(jnp.isfinite(abs_tan), l, 0.0)

    def g1(self, w):
        return 1.0 / (1.0 + self.lambda_(w))

    def g(self, wo, wi):
        return 1.0 / (1.0 + self.lambda_(wo) + self.lambda_(wi))

    def sample_wh(self, wo, u):
        if self.sample_visible:
            return self._sample_wh_vndf(wo, u)
        return self._sample_wh_classic(u)

    def _sample_wh_vndf(self, w, u):
        """Heitz 2018 VNDF sampling (microfacet.rs:117-138)."""
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        wh = normalize(jnp.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], axis=-1))
        wh = jnp.where(wh[..., 2:3] < 0.0, -wh, wh)
        z_axis = jnp.zeros_like(wh).at[..., 2].set(1.0)
        t1 = jnp.where(
            (wh[..., 2:3] < 0.99999),
            normalize(jnp.cross(z_axis, wh)),
            jnp.zeros_like(wh).at[..., 0].set(1.0),
        )
        t2 = normalize(jnp.cross(wh, t1))
        p = uniform_sample_disk(u)
        h = jnp.sqrt(jnp.maximum(0.0, 1.0 - p[..., 0] ** 2))
        lerp_t = (1.0 + wh[..., 2]) * 0.5
        py = h + (p[..., 1] - h) * lerp_t
        pz = jnp.sqrt(jnp.maximum(0.0, 1.0 - p[..., 0] ** 2 - py**2))
        nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
        wh = normalize(
            jnp.stack(
                [ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6)], axis=-1
            )
        )
        return wh

    def _sample_wh_classic(self, u):
        """Classic NDF sampling with analytic inverse (microfacet.rs:67-89)."""
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        iso = True  # anisotropic classic sampling only needed for MCMC aniso
        phi_i = TWO_PI * u[..., 1]
        tan2_i = ax * ax * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-12)
        cos_i = 1.0 / jnp.sqrt(1.0 + tan2_i)
        # anisotropic branch
        phi_a = jnp.arctan(ay / ax * jnp.tan(TWO_PI * u[..., 1] + 0.5 * PI))
        phi_a = jnp.where(u[..., 1] > 0.5, phi_a + PI, phi_a)
        sp, cp = jnp.sin(phi_a), jnp.cos(phi_a)
        a2 = 1.0 / (cp**2 / jnp.maximum(ax * ax, 1e-12) + sp**2 / jnp.maximum(ay * ay, 1e-12))
        tan2_a = a2 * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-12)
        cos_a = 1.0 / jnp.sqrt(1.0 + tan2_a)
        is_iso = ax == ay
        phi = jnp.where(is_iso, phi_i, phi_a)
        cos_t = jnp.where(is_iso, cos_i, cos_a)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t**2))
        wh = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
        z_axis = jnp.zeros_like(wh).at[..., 2].set(1.0)
        return face_forward(wh, z_axis)

    def invert_wh(self, wo, wh):
        """Analytic inverse of classic sampling (microfacet.rs:153-195),
        isotropic AND anisotropic — needed for MCMC replay through GGX lobes."""
        assert not self.sample_visible, "invert_wh requires classic sampling"
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        x, y, cos_t = wh[..., 0], wh[..., 1], wh[..., 2]
        tan2 = 1.0 / jnp.maximum(cos_t**2, 1e-12) - 1.0
        # isotropic: phi = 2*pi*u1 directly
        phi = jnp.arctan2(y, x)
        uy_i = jnp.mod(phi * INV_2PI, 1.0)
        ga_i = tan2 / jnp.maximum(ax * ax, 1e-12)
        ux_i = ga_i / (1.0 + ga_i)
        # anisotropic: sampling sets tan(phi) = (ay/ax) tan(psi) with
        # psi = 2*pi*u1 + pi/2; the arctan branch structure maps psi to the
        # OPPOSITE quadrant of phi (tan has period pi), so
        # psi = atan2(ax*y, ay*x) + pi  (mod 2*pi is absorbed by the mod below)
        psi = jnp.arctan2(ax * y, ay * x) + PI
        uy_a = jnp.mod((psi - 0.5 * PI) * INV_2PI, 1.0)
        r2 = jnp.maximum(x * x + y * y, 1e-24)
        inv_a2 = (x * x / r2) / jnp.maximum(ax * ax, 1e-12) + (
            y * y / r2
        ) / jnp.maximum(ay * ay, 1e-12)
        ga_a = tan2 * inv_a2
        ux_a = ga_a / (1.0 + ga_a)
        is_iso = ax == ay
        ux = jnp.where(is_iso, ux_i, ux_a)
        uy = jnp.where(is_iso, uy_i, uy_a)
        return jnp.stack([ux, uy], axis=-1)

    def pdf(self, wo, wh):
        if self.sample_visible:
            return (
                self.d(wh) * self.g1(wo) * jnp.abs(jnp.sum(wo * wh, -1)) / jnp.maximum(Frame.abs_cos_theta(wo), 1e-12)
            )
        return self.d(wh) * Frame.abs_cos_theta(wh)


# ---- Fresnel ----------------------------------------------------------------
def fr_dielectric(cos_theta_i, eta):
    """Dielectric Fresnel; eta = eta_t/eta_i for cos>0 side (surface/mod.rs:1008-1036)."""
    cos_theta_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    eta = jnp.where(cos_theta_i > 0.0, eta, 1.0 / eta)
    cos_theta_i = jnp.abs(cos_theta_i)
    sin2_i = 1.0 - cos_theta_i**2
    sin2_t = sin2_i / jnp.maximum(eta**2, 1e-12)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    r_parl = (eta * cos_theta_i - cos_t) / jnp.maximum(eta * cos_theta_i + cos_t, 1e-12)
    r_perp = (cos_theta_i - eta * cos_t) / jnp.maximum(cos_theta_i + eta * cos_t, 1e-12)
    fr = 0.5 * (r_parl**2 + r_perp**2)
    return jnp.where(tir, 1.0, jnp.clip(fr, 0.0, 1.0))


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = jnp.maximum(br * br + bi * bi, 1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _csqrt(ar, ai):
    r = jnp.sqrt(jnp.maximum(ar * ar + ai * ai, 0.0))
    re = jnp.sqrt(jnp.maximum((r + ar) * 0.5, 0.0))
    im = jnp.sign(ai) * jnp.sqrt(jnp.maximum((r - ar) * 0.5, 0.0))
    return re, im


def fr_complex(cos_theta_i, n, k):
    """Conductor Fresnel with complex IOR n + ik, per channel
    (surface/mod.rs:1054-1081). Real arithmetic, no complex dtype.

    cos_theta_i: [N]; n, k: [N, 3] -> returns [N, 3].
    """
    ci = jnp.clip(cos_theta_i, 0.0, 0.999)[..., None]
    sin2 = 1.0 - ci * ci
    # sin2_t = sin2 / eta^2
    e2r, e2i = _cmul(n, k, n, k)
    s2tr, s2ti = _cdiv(sin2, jnp.zeros_like(sin2), e2r, e2i)
    # cos_t = sqrt(1 - sin2_t)
    ctr, cti = _csqrt(1.0 - s2tr, -s2ti)
    # r_parl = (eta ci - cos_t) / (eta ci + cos_t)
    ecr, eci = n * ci, k * ci
    num_r, num_i = ecr - ctr, eci - cti
    den_r, den_i = ecr + ctr, eci + cti
    rp_r, rp_i = _cdiv(num_r, num_i, den_r, den_i)
    # r_perp = (ci - eta cos_t) / (ci + eta cos_t)
    ect_r, ect_i = _cmul(n, k, ctr, cti)
    num_r, num_i = ci - ect_r, -ect_i
    den_r, den_i = ci + ect_r, ect_i
    rs_r, rs_i = _cdiv(num_r, num_i, den_r, den_i)
    return 0.5 * ((rp_r**2 + rp_i**2) + (rs_r**2 + rs_i**2))


def f0_from_ior(ior):
    f0 = (ior - 1.0) / (ior + 1.0)
    return f0 * f0


def ior_from_f0(f0):
    s = jnp.sqrt(jnp.clip(f0, 0.0, 0.99))
    return (1.0 + s) / (1.0 - s)


def fr_schlick(f0, f90, cos_theta_i):
    c = jnp.abs(jnp.clip(cos_theta_i, -1.0, 1.0))
    return f0 + (f90 - f0) * (1.0 - c)[..., None] ** 5


def artistic_to_conductor_fresnel(color, tint):
    """Gulbrandsen's artistic conductor parametrization (surface/mod.rs:1038-1052)."""
    r = jnp.clip(color, 0.0, 0.99)
    g = tint
    r_sqrt = jnp.sqrt(r)
    n_min = (1.0 - r) / (1.0 + r)
    n_max = (1.0 + r_sqrt) / jnp.maximum(1.0 - r_sqrt, 1e-6)
    n = n_max + (n_min - n_max) * g
    k2 = ((n + 1.0) ** 2 * r - (n - 1.0) ** 2) / jnp.maximum(1.0 - r, 1e-6)
    k = jnp.sqrt(jnp.maximum(k2, 0.0))
    return n, k
