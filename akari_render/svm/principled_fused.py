"""Fused principled BSDF: flat evaluation equivalent to the combinator tree.

The combinator tree (svm/eval.py::_principled, mirroring principled.rs)
evaluates FIVE separate microfacet lobes; three of them (specular layer,
dielectric reflection, metal) share the SAME GGX distribution (alpha =
roughness^2), so their D/G/pdf are identical and only the Fresnel-weighted
colors differ. This class computes the exact same f/pdf with:

  1x GGX reflection eval (shared alpha) + 1x coat GGX eval +
  1x GGX transmission eval + diffuse + 3 Fresnels

The tree's extra cost over the fused math is pure recomputation.

Weight algebra (matches the tree exactly; see _principled for the source):
  B_r, pdf_r       = shared GGX reflection base (f without color) and pdf
  f_spec           = B_r * Frd(spec_eta) * spec_tint * f0
  f_diel_refl      = B_r * Frd(eta) * base_color
  f_metal          = B_r * Frc(n, k)
  f_trans, pdf_t   = GGX transmission with (1-Frd(eta)) * sqrt(base_color)
  f_diff, pdf_d    = lambert(base_color/pi)
  f_diel  = f_trans + f_diel_refl ; pdf_diel = lerp(pdf_t, pdf_r, Frd(cos_o))
  f_bot   = lerp(f_diff, f_diel, transmission); pdf_bot likewise
  f_sc    = f_spec + f_bot * min(1-eo_s, 1-ei_s)
  pdf_sc  = pdf_r * mean(eo_s) + pdf_bot * (1 - mean(eo_s))
  f_in    = lerp(f_sc, f_metal, metallic); pdf_in = lerp(pdf_sc, pdf_r, metallic)
  f       = f_coat + f_in * w_tint * min(1-eo_c, 1-ei_c)
  pdf     = pdf_c * mean(eo_c) + pdf_in * (1 - mean(eo_c))
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.math import Frame, face_forward, normalize, reflect, refract
from ..core.sampling import (
    INV_PI,
    cos_sample_hemisphere,
    weighted_discrete_choice2_and_remap,
)
from .microfacet import (
    TrowbridgeReitz,
    artistic_to_conductor_fresnel,
    fr_complex,
    fr_dielectric,
)
from .surface import MicrofacetTransmission, Surface


class FusedPrincipled(Surface):
    def __init__(self, *, base_color, metallic, roughness, eta, transmission,
                 spec_eta, specular_weight, specular_tint,
                 coat_weight, coat_roughness, coat_ior, coat_tint,
                 emission, spec_albedo_fn, coat_albedo_fn,
                 static_zero: frozenset = frozenset()):
        # static (trace-time) dead-lobe elimination: members of static_zero
        # ("metallic" | "transmission" | "coat") are constant 0 for every
        # material of this kind, so their lobes are omitted entirely.
        # BIT-EXACT: a weighted choice with probability 0 never picks and
        # leaves the random unchanged ((u - 0)/(1 - 0) = u), and every
        # eliminated term enters f/pdf only scaled by the zero weight.
        self.static_zero = static_zero
        self.color = base_color
        self.kt = jnp.sqrt(jnp.clip(base_color, 0.0, None))
        self.metallic = metallic
        self.rough = roughness
        self.eta = eta
        self.transmission = transmission
        self.spec_eta = spec_eta
        self.specular_weight = specular_weight  # f0
        self.specular_tint = specular_tint
        self.coat_weight = coat_weight
        self.coat_roughness = coat_roughness
        self.coat_ior = coat_ior
        self.coat_tint = coat_tint
        self._emission = emission
        self.spec_albedo_fn = spec_albedo_fn  # cos -> [N]
        self.coat_albedo_fn = coat_albedo_fn
        self.dist_r = TrowbridgeReitz.from_roughness(roughness)
        self.dist_c = TrowbridgeReitz.from_roughness(coat_roughness)
        self.n_m, self.k_m = artistic_to_conductor_fresnel(base_color, specular_tint)

    # --- shared helpers ---
    def _eo_s(self, w):
        return self.specular_tint * (
            self.spec_albedo_fn(Frame.abs_cos_theta(w)) * self.specular_weight
        )[..., None]

    def _eo_c(self, w):
        if "coat" in self.static_zero:
            return jnp.zeros(w.shape[:-1] + (3,))
        return (self.coat_weight * self.coat_albedo_fn(Frame.abs_cos_theta(w)))[
            ..., None
        ] * jnp.ones(3)

    def _w_tint(self):
        if "coat" in self.static_zero:
            return jnp.ones(3)
        return 1.0 + (self.coat_tint - 1.0) * self.coat_weight[..., None]

    def _ggx_refl_base(self, dist, wo, wi):
        """(B, pdf, fresnel_cos): GGX reflection without color/Fresnel."""
        wh = wo + wi
        cos_o = Frame.cos_theta(wo)
        cos_i = Frame.cos_theta(wi)
        degenerate = (
            (jnp.sum(wh * wo, -1) * jnp.sum(wi * wh, -1) < 0.0)
            | jnp.all(wh == 0.0, -1)
            | (cos_i == 0.0)
            | (cos_o == 0.0)
            | ~Frame.same_hemisphere(wo, wi)
        )
        wh = normalize(wh)
        z_axis = jnp.zeros_like(wh).at[..., 2].set(1.0)
        fcos = jnp.sum(wi * face_forward(wh, z_axis), -1)
        d = dist.d(wh)
        g = dist.g(wo, wi)
        denom = cos_i * cos_o
        B = jnp.abs(0.25 * d * g / jnp.where(denom == 0, 1.0, denom)) * jnp.abs(cos_i)
        pdf = dist.pdf(wo, wh) / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-12)
        B = jnp.where(degenerate, 0.0, B)
        pdf = jnp.where(degenerate, 0.0, pdf)
        return B, pdf, fcos

    def _ggx_trans(self, wo, wi):
        """Transmission f (with (1-F)*kt) and pdf — same as the tree lobe."""
        fresnel = lambda c: fr_dielectric(c, self.eta)[..., None] * jnp.ones(3)
        lobe = MicrofacetTransmission(self.kt, self.eta, fresnel, self.dist_r)
        return lobe.evaluate(wo, wi)

    # --- Surface interface ---
    def evaluate(self, wo, wi):
        z = self.static_zero
        B_r, pdf_r, fcos_r = self._ggx_refl_base(self.dist_r, wo, wi)
        same_hemi = Frame.same_hemisphere(wo, wi)

        f_spec = (
            B_r[..., None]
            * fr_dielectric(fcos_r, self.spec_eta)[..., None]
            * self.specular_tint
            * self.specular_weight[..., None]
        )

        cos_i = Frame.abs_cos_theta(wi)
        f_diff = jnp.where(
            same_hemi[..., None], self.color * INV_PI * cos_i[..., None], 0.0
        )
        pdf_d = jnp.where(same_hemi, cos_i * INV_PI, 0.0)

        if "transmission" in z:
            f_bot, pdf_bot = f_diff, pdf_d
        else:
            f_diel_refl = (
                B_r[..., None] * fr_dielectric(fcos_r, self.eta)[..., None] * self.color
            )
            f_trans, pdf_t = self._ggx_trans(wo, wi)
            fr_o = fr_dielectric(Frame.cos_theta(wo), self.eta)
            f_diel = f_trans + f_diel_refl
            pdf_diel = pdf_t + (pdf_r - pdf_t) * fr_o
            tr = self.transmission[..., None]
            f_bot = f_diff + (f_diel - f_diff) * tr
            pdf_bot = pdf_d + (pdf_diel - pdf_d) * self.transmission

        eo_s, ei_s = self._eo_s(wo), self._eo_s(wi)
        p_s = jnp.mean(eo_s, -1)
        f_sc = f_spec + f_bot * jnp.minimum(1.0 - eo_s, 1.0 - ei_s)
        pdf_sc = pdf_r * p_s + pdf_bot * (1.0 - p_s)

        if "metallic" in z:
            f_in, pdf_in = f_sc, pdf_sc
        else:
            f_metal = B_r[..., None] * fr_complex(jnp.abs(fcos_r), self.n_m, self.k_m)
            m = self.metallic[..., None]
            f_in = f_sc + (f_metal - f_sc) * m
            pdf_in = pdf_sc + (pdf_r - pdf_sc) * self.metallic

        if "coat" in z:
            return f_in, pdf_in
        B_c, pdf_c, fcos_c = self._ggx_refl_base(self.dist_c, wo, wi)
        f_coat = (
            B_c[..., None]
            * fr_dielectric(fcos_c, self.coat_ior)[..., None]
            * self.coat_weight[..., None]
        )
        eo_c, ei_c = self._eo_c(wo), self._eo_c(wi)
        p_c = jnp.mean(eo_c, -1)
        f = f_coat + f_in * self._w_tint() * jnp.minimum(1.0 - eo_c, 1.0 - ei_c)
        pdf = pdf_c * p_c + pdf_in * (1.0 - p_c)
        return f, pdf

    def sample_wi(self, wo, u_select, u_sample):
        """Replicates the tree's weighted-choice cascade exactly (same
        remapped randoms at each level) so samplers replay identically.
        Statically-zero levels are skipped: probability 0 never picks and
        the remap is the identity, so streams stay bit-identical."""
        z = self.static_zero
        false = jnp.zeros(wo.shape[:-1], bool)
        # level 1: coat (prob mean(eo_c)) vs inner
        if "coat" in z:
            pick_coat, u1 = false, u_select
        else:
            p_c = jnp.mean(self._eo_c(wo), -1)
            pick_coat, u1 = weighted_discrete_choice2_and_remap(p_c, u_select)
        # level 2 (inner): metal with prob metallic
        if "metallic" in z:
            pick_metal, u2 = false, u1
        else:
            pick_metal, u2 = weighted_discrete_choice2_and_remap(self.metallic, u1)
        # level 3 (speccoat): spec (prob mean(eo_s)) vs bottom
        p_s = jnp.mean(self._eo_s(wo), -1)
        pick_spec, u3 = weighted_discrete_choice2_and_remap(p_s, u2)
        # level 4 (bottom Mix): dielectric with prob transmission
        if "transmission" in z:
            pick_diel, u4 = false, u3
            pick_refl = false
        else:
            pick_diel, u4 = weighted_discrete_choice2_and_remap(self.transmission, u3)
            # level 5 (diel Add): reflection with prob Frd(cos_o)
            fr_o = fr_dielectric(Frame.cos_theta(wo), self.eta)
            pick_refl, u5 = weighted_discrete_choice2_and_remap(fr_o, u4)

        wh_r = self.dist_r.sample_wh(wo, u_sample)
        wi_refl_r = reflect(wo, wh_r)
        wi_diff = cos_sample_hemisphere(u_sample)
        wi_diff = jnp.where(Frame.same_hemisphere(wo, wi_diff)[..., None], wi_diff, -wi_diff)
        same_r = Frame.same_hemisphere(wo, wi_refl_r)

        # cascade select
        use_refl_r = ~pick_coat & (pick_metal | pick_spec | (pick_diel & pick_refl))
        use_trans = ~pick_coat & ~pick_metal & ~pick_spec & pick_diel & ~pick_refl

        if "transmission" in z:
            wi_lo = wi_diff
            valid_lo = jnp.ones(wo.shape[:-1], bool)
        else:
            ok_t, _, wi_trans = refract(wo, wh_r, self.eta)
            valid_t = ok_t & ~Frame.same_hemisphere(wo, wi_trans)
            wi_lo = jnp.where(use_trans[..., None], wi_trans, wi_diff)
            valid_lo = jnp.where(use_trans, valid_t, True)

        wi_in = jnp.where(use_refl_r[..., None], wi_refl_r, wi_lo)
        valid_in = jnp.where(use_refl_r, same_r, valid_lo)
        if "coat" in z:
            return wi_in, valid_in
        wh_c = self.dist_c.sample_wh(wo, u_sample)
        wi_refl_c = reflect(wo, wh_c)
        same_c = Frame.same_hemisphere(wo, wi_refl_c)
        wi = jnp.where(pick_coat[..., None], wi_refl_c, wi_in)
        valid = jnp.where(pick_coat, same_c, valid_in)
        return wi, valid

    def albedo(self, wo):
        z = self.static_zero
        eo_s = self._eo_s(wo)
        if "transmission" in z:
            alb_bot = self.color
        else:
            alb_diel = self.color + self.kt
            alb_bot = self.color + (alb_diel - self.color) * self.transmission[..., None]
        alb_sc = (self.specular_tint * self.specular_weight[..., None]) * eo_s + alb_bot * (
            1.0 - eo_s
        )
        if "metallic" in z:
            alb_in = alb_sc
        else:
            alb_in = alb_sc + (jnp.ones_like(self.color) - alb_sc) * self.metallic[..., None]
        if "coat" in z:
            return alb_in
        eo_c = self._eo_c(wo)
        top = self.coat_weight[..., None] * jnp.ones(3)
        return top * eo_c + (alb_in * self._w_tint()) * (1.0 - eo_c)

    def emission(self, wo):
        if "coat" in self.static_zero:
            return self._emission
        eo_c = self._eo_c(wo)
        return self._emission * self._w_tint() * (1.0 - eo_c)

    def roughness(self, wo, u_select):
        z = self.static_zero
        false = jnp.zeros(wo.shape[:-1], bool)
        if "coat" in z:
            pick_coat, u1 = false, u_select
        else:
            p_c = jnp.mean(self._eo_c(wo), -1)
            pick_coat, u1 = weighted_discrete_choice2_and_remap(p_c, u_select)
        if "metallic" in z:
            pick_metal, u2 = false, u1
        else:
            pick_metal, u2 = weighted_discrete_choice2_and_remap(self.metallic, u1)
        pick_spec, u3 = weighted_discrete_choice2_and_remap(jnp.mean(self._eo_s(wo), -1), u2)
        if "transmission" in z:
            pick_diel = false
        else:
            pick_diel, u4 = weighted_discrete_choice2_and_remap(self.transmission, u3)
        r = jnp.where(
            pick_coat,
            self.dist_c.roughness,
            jnp.where(
                pick_metal | pick_spec | pick_diel,
                self.dist_r.roughness,
                1.0,
            ),
        )
        return jnp.broadcast_to(r, wo.shape[:-1])

    def alpha(self, shape):
        return jnp.ones(shape)
