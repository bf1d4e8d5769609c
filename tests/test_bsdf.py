"""BSDF statistical tests — the port of the reference's akari-test
harness (crates/akari_api/src/bin/akari_test.rs:16-439): chi-square tests of
`sample_wi` histograms against the claimed pdf, plus energy and reciprocity
checks, for each BSDF family.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from akari_render.core.math import Frame
from akari_render.core.samplers import IndependentSampler
from akari_render.svm.microfacet import TrowbridgeReitz, fr_dielectric
from akari_render.svm.surface import (
    BsdfMixture,
    DiffuseBsdf,
    MicrofacetReflection,
    MicrofacetTransmission,
)

N_SAMPLES = 200_000
THETA_BINS = 16
PHI_BINS = 32


def _sample_bsdf(surface, wo, n):
    s = IndependentSampler.new(jnp.arange(n, dtype=jnp.uint32), seed=42)
    s, u_sel = s.next_1d()
    s, u = s.next_2d()
    wo_b = jnp.broadcast_to(jnp.asarray(wo, jnp.float32), (n, 3))
    wi, valid = surface.sample_wi(wo_b, u_sel, u)
    _, pdf = surface.evaluate(wo_b, wi)
    return np.asarray(wi), np.asarray(valid & (pdf > 0)), np.asarray(pdf)


def _histogram(wi, valid):
    """Bin directions over the full sphere: theta in [0, pi], phi in [0, 2pi]."""
    theta = np.arccos(np.clip(wi[:, 2], -1, 1))
    phi = np.mod(np.arctan2(wi[:, 1], wi[:, 0]), 2 * np.pi)
    ti = np.minimum((theta / np.pi * THETA_BINS).astype(int), THETA_BINS - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * PHI_BINS).astype(int), PHI_BINS - 1)
    counts = np.zeros((THETA_BINS, PHI_BINS))
    np.add.at(counts, (ti[valid], pi_[valid]), 1.0)
    return counts


def _expected_counts(surface, wo, n_total, sub=8):
    """Integrate the claimed pdf over each bin with tolerance-driven
    adaptive Simpson — the reference's integrate_pdf protocol
    (akari_test.rs:70-112: adaptive_simpson_2d per bin, phi outer / theta
    inner, integrand pdf*sin(theta), eps=1e-6, max_depth=6). `sub` scales
    the refinement depth for sharp lobes (kept for call compatibility)."""
    from akari_render.core.integration import adaptive_simpson_2d_batch

    t_h = np.pi / THETA_BINS
    p_h = 2 * np.pi / PHI_BINS
    ti, pi_ = np.meshgrid(np.arange(THETA_BINS), np.arange(PHI_BINS),
                          indexing="ij")
    ti = ti.ravel()
    pi_ = pi_.ravel()

    def pdf_sin(phis, thetas, owners):
        wi = np.stack(
            [
                np.sin(thetas) * np.cos(phis),
                np.sin(thetas) * np.sin(phis),
                np.cos(thetas),
            ],
            -1,
        )
        wo_b = jnp.broadcast_to(jnp.asarray(wo, jnp.float32), (wi.shape[0], 3))
        _, pdf = surface.evaluate(wo_b, jnp.asarray(wi, jnp.float32))
        return np.asarray(pdf, np.float64) * np.sin(thetas)

    depth = 6 + (3 if sub > 8 else 0)
    mass = adaptive_simpson_2d_batch(
        pdf_sin,
        pi_ * p_h, (pi_ + 1) * p_h,  # phi outer
        ti * t_h, (ti + 1) * t_h,  # theta inner
        eps=1e-6, max_depth=depth,
    )
    return mass.reshape(THETA_BINS, PHI_BINS) * n_total


def _chi2_threshold(dof, alpha=1e-3):
    """Wilson-Hilferty approximation of the chi2 upper quantile."""
    from math import sqrt

    z = 3.09  # z_{1-1e-3}
    return dof * (1 - 2 / (9 * dof) + z * sqrt(2 / (9 * dof))) ** 3


def _run_chi2(surface, wo, n=N_SAMPLES, sub=8):
    """Pooled chi2 (merge low-expectation cells like akari_test.rs:139-219)."""
    wi, valid, _ = _sample_bsdf(surface, wo, n)
    n_valid = valid.sum()
    obs = _histogram(wi, valid)
    exp = _expected_counts(surface, wo, n, sub=sub)
    # The sampler may emit invalid samples (e.g. below-horizon GGX); the pdf
    # claimed by evaluate() only covers valid ones — normalize both to the
    # same mass to test SHAPE (the pdf-integrates-to-valid-fraction property
    # is checked separately in energy tests).
    obs_f = obs.ravel()
    exp_f = exp.ravel()
    pooled_obs, pooled_exp, chi2 = 0.0, 0.0, 0.0
    dof = 0
    for o, e in zip(obs_f, exp_f):
        pooled_obs += o
        pooled_exp += e
        if pooled_exp >= 5.0:
            chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
            dof += 1
            pooled_obs, pooled_exp = 0.0, 0.0
    assert dof > 5, "degenerate chi2 binning"
    thresh = _chi2_threshold(dof)
    assert chi2 < thresh, f"chi2={chi2:.1f} > {thresh:.1f} (dof={dof})"


def _wo(theta_deg):
    t = np.deg2rad(theta_deg)
    return np.array([np.sin(t), 0.0, np.cos(t)], np.float32)


@pytest.mark.slow
class TestDiffuseChi2:
    def test_normal_incidence(self):
        _run_chi2(DiffuseBsdf(jnp.ones(3) / np.pi), _wo(0.0))

    def test_grazing(self):
        _run_chi2(DiffuseBsdf(jnp.ones(3) / np.pi), _wo(75.0))


@pytest.mark.slow
class TestGGXReflectionChi2:
    @pytest.mark.parametrize("rough", [0.1, 0.3, 0.6, 1.0])
    def test_vndf(self, rough):
        dist = TrowbridgeReitz.from_roughness(jnp.float32(rough))
        bsdf = MicrofacetReflection(
            jnp.ones(3), lambda c: jnp.ones(3) * jnp.ones_like(c)[..., None], dist
        )
        # sharp lobes need a finer subgrid for the pdf bin integrals
        _run_chi2(bsdf, _wo(30.0), sub=32 if rough < 0.3 else 8)

    def test_classic_sampling(self):
        dist = TrowbridgeReitz.from_roughness(jnp.float32(0.5), sample_visible=False)
        bsdf = MicrofacetReflection(
            jnp.ones(3), lambda c: jnp.ones(3) * jnp.ones_like(c)[..., None], dist
        )
        _run_chi2(bsdf, _wo(30.0))


@pytest.mark.slow
class TestGGXTransmissionChi2:
    @pytest.mark.parametrize("rough", [0.3, 0.8])
    def test_transmission(self, rough):
        eta = jnp.float32(1.5)
        dist = TrowbridgeReitz.from_roughness(jnp.float32(rough))
        fresnel = lambda c: fr_dielectric(c, eta)[..., None] * jnp.ones(3)
        bsdf = MicrofacetTransmission(jnp.ones(3), eta, fresnel, dist)
        _run_chi2(bsdf, _wo(30.0))


@pytest.mark.slow
class TestGlassChi2:
    def test_glass_mixture(self):
        eta = jnp.float32(1.5)
        rough = jnp.float32(0.4)
        dist = TrowbridgeReitz.from_roughness(rough)
        fresnel = lambda c: fr_dielectric(c, eta)[..., None] * jnp.ones(3)
        refl = MicrofacetReflection(jnp.ones(3), fresnel, dist)
        trans = MicrofacetTransmission(jnp.ones(3), eta, fresnel, dist)
        glass = BsdfMixture(
            lambda wo: fr_dielectric(Frame.cos_theta(wo), eta), trans, refl, "add"
        )
        _run_chi2(glass, _wo(45.0))


class TestEnergy:
    def test_white_diffuse_furnace(self):
        """E[f/pdf] for white lambert == 1 exactly."""
        bsdf = DiffuseBsdf(jnp.ones(3) / np.pi)
        wo = _wo(37.0)
        n = 100_000
        s = IndependentSampler.new(jnp.arange(n, dtype=jnp.uint32), seed=5)
        s, u_sel = s.next_1d()
        s, u = s.next_2d()
        wo_b = jnp.broadcast_to(jnp.asarray(wo), (n, 3))
        wi, valid = bsdf.sample_wi(wo_b, u_sel, u)
        f, pdf = bsdf.evaluate(wo_b, wi)
        est = np.asarray(f[..., 0] / jnp.maximum(pdf, 1e-20))
        assert abs(est[np.asarray(valid)].mean() - 1.0) < 2e-3

    @pytest.mark.parametrize("rough", [0.2, 0.7])
    def test_ggx_energy_below_one(self, rough):
        """White GGX reflection never gains energy."""
        dist = TrowbridgeReitz.from_roughness(jnp.float32(rough))
        bsdf = MicrofacetReflection(
            jnp.ones(3), lambda c: jnp.ones(3) * jnp.ones_like(c)[..., None], dist
        )
        wo = _wo(40.0)
        n = 100_000
        s = IndependentSampler.new(jnp.arange(n, dtype=jnp.uint32), seed=6)
        s, u_sel = s.next_1d()
        s, u = s.next_2d()
        wo_b = jnp.broadcast_to(jnp.asarray(wo), (n, 3))
        wi, valid = bsdf.sample_wi(wo_b, u_sel, u)
        f, pdf = bsdf.evaluate(wo_b, wi)
        w = np.asarray(
            jnp.where(valid & (pdf > 0), f[..., 0] / jnp.maximum(pdf, 1e-20), 0.0)
        )
        assert w.mean() <= 1.0 + 1e-2

    def test_reciprocity_diffuse(self):
        """f(wo,wi)/cos(wi) == f(wi,wo)/cos(wo) for lambert."""
        bsdf = DiffuseBsdf(jnp.full(3, 0.5 / np.pi))
        rng = np.random.default_rng(0)
        v = rng.normal(size=(64, 2, 3)).astype(np.float32)
        v[..., 2] = np.abs(v[..., 2])
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        wo, wi = jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1])
        f1, _ = bsdf.evaluate(wo, wi)
        f2, _ = bsdf.evaluate(wi, wo)
        r1 = np.asarray(f1[..., 0]) / np.abs(v[:, 1, 2])
        r2 = np.asarray(f2[..., 0]) / np.abs(v[:, 0, 2])
        np.testing.assert_allclose(r1, r2, rtol=1e-5)


class TestInversion:
    """Sampler inversion round-trips (akari_test.rs:440-510) — required for
    MCMC replay correctness."""

    def test_ggx_classic_invert_wh(self):
        dist = TrowbridgeReitz.from_roughness(
            jnp.full((4096,), 0.5), sample_visible=False
        )
        rng = np.random.default_rng(3)
        u = jnp.asarray(rng.uniform(0.01, 0.99, (4096, 2)).astype(np.float32))
        wo = jnp.broadcast_to(jnp.asarray(_wo(30.0)), (4096, 3))
        wh = dist.sample_wh(wo, u)
        u2 = np.asarray(dist.invert_wh(wo, wh))
        bad = (np.abs(u2 - np.asarray(u)) > 0.01).any(axis=-1)
        assert bad.mean() < 0.01, f"{bad.mean():.3%} failed round-trip"


class TestFusedPrincipled:
    """A/B equivalence of the fused principled path against the combinator
    tree (the chi2-anchored correctness reference). Both are constructed by
    eval.build_principled_surface; exact same math must come out."""

    def _make_pair(self, rng, n, **overrides):
        from akari_render.svm.eval import build_principled_surface

        def arr(lo, hi):
            return jnp.asarray(rng.uniform(lo, hi, n), jnp.float32)

        def col(lo=0.0, hi=1.0):
            return jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)

        params = dict(
            color=col(),
            emission=col(0.0, 2.0),
            metallic=arr(0, 1),
            roughness=arr(0.05, 1.0),
            eta=arr(1.1, 2.0),
            transmission=arr(0, 1),
            specular_ior_level=arr(0.1, 0.9),
            specular_tint=col(0.2, 1.0),
            coat_weight=arr(0, 1),
            coat_roughness=arr(0.05, 0.6),
            coat_ior=arr(1.2, 1.8),
            coat_tint=col(0.5, 1.0),
        )
        params.update(overrides)
        tree = build_principled_surface(**params, fused=False)
        fused = build_principled_surface(**params, fused=True)
        return tree, fused

    def _dirs(self, rng, n):
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return jnp.asarray(v, jnp.float32)

    def test_evaluate_matches_tree(self):
        rng = np.random.default_rng(7)
        n = 4096
        tree, fused = self._make_pair(rng, n)
        wo = self._dirs(rng, n)
        wi = self._dirs(rng, n)  # full sphere: exercises refl + trans branches
        f_t, p_t = tree.evaluate(wo, wi)
        f_f, p_f = fused.evaluate(wo, wi)
        np.testing.assert_allclose(np.asarray(f_f), np.asarray(f_t), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(np.asarray(p_f), np.asarray(p_t), rtol=2e-5, atol=2e-6)

    def test_sample_matches_tree(self):
        rng = np.random.default_rng(11)
        n = 4096
        tree, fused = self._make_pair(rng, n)
        wo = self._dirs(rng, n)
        u_sel = jnp.asarray(rng.uniform(size=n), jnp.float32)
        u = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
        wi_t, v_t = tree.sample_wi(wo, u_sel, u)
        wi_f, v_f = fused.sample_wi(wo, u_sel, u)
        v_t, v_f = np.asarray(v_t), np.asarray(v_f)
        np.testing.assert_array_equal(v_f, v_t)
        np.testing.assert_allclose(
            np.asarray(wi_f)[v_t], np.asarray(wi_t)[v_t], rtol=1e-5, atol=1e-6
        )

    def test_aux_match_tree(self):
        rng = np.random.default_rng(13)
        n = 1024
        tree, fused = self._make_pair(rng, n)
        wo = self._dirs(rng, n)
        u_sel = jnp.asarray(rng.uniform(size=n), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(fused.albedo(wo)), np.asarray(tree.albedo(wo)), rtol=2e-5, atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(fused.emission(wo)), np.asarray(tree.emission(wo)), rtol=2e-5, atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(fused.roughness(wo, u_sel)),
            np.asarray(tree.roughness(wo, u_sel)),
            rtol=1e-6,
        )

    def test_pure_metal_and_pure_glassy_corners(self):
        """Degenerate parameter corners where mixtures collapse."""
        rng = np.random.default_rng(17)
        n = 2048
        ones = jnp.ones((n,), jnp.float32)
        zeros = jnp.zeros((n,), jnp.float32)
        for ov in (
            dict(metallic=ones, transmission=zeros, coat_weight=zeros),
            dict(metallic=zeros, transmission=ones, coat_weight=zeros),
            dict(metallic=zeros, transmission=zeros, coat_weight=ones),
        ):
            tree, fused = self._make_pair(rng, n, **ov)
            wo = self._dirs(rng, n)
            wi = self._dirs(rng, n)
            f_t, p_t = tree.evaluate(wo, wi)
            f_f, p_f = fused.evaluate(wo, wi)
            np.testing.assert_allclose(np.asarray(f_f), np.asarray(f_t), rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(np.asarray(p_f), np.asarray(p_t), rtol=2e-5, atol=2e-6)


@pytest.mark.slow
class TestPlasticChi2:
    """Tungsten plastic (svm/surface.py::PlasticBsdf, ref plastic.rs:38-178):
    sample_wi histogram must match the mixture pdf claimed by evaluate."""

    def _make(self, rough=0.3, kd=(0.6, 0.3, 0.2), eta=1.5, sigma_a=None):
        from akari_render.svm.surface import PlasticBsdf

        n = ()
        kd_a = jnp.asarray(kd, jnp.float32)[None]  # broadcastable [1, 3]
        eta_a = jnp.full((1,), eta, jnp.float32)
        r_a = jnp.full((1,), rough, jnp.float32)
        sig = jnp.asarray(sigma_a, jnp.float32)[None] if sigma_a else None
        return PlasticBsdf(kd_a, eta_a, r_a, sig, None)

    @pytest.mark.parametrize("rough", [0.15, 0.5])
    def test_chi2(self, rough):
        _run_chi2(self._make(rough=rough), _wo(30))

    def test_chi2_grazing(self):
        _run_chi2(self._make(rough=0.4), _wo(70))

    def test_energy_below_one(self):
        """White-ish furnace: total reflected energy must stay below 1."""
        surf = self._make(rough=0.3, kd=(0.9, 0.9, 0.9))
        wo = _wo(35)
        n = 100_000
        wi, valid, pdf = _sample_bsdf(surf, wo, n)
        f, _ = surf.evaluate(
            jnp.broadcast_to(jnp.asarray(wo), (n, 3)), jnp.asarray(wi)
        )
        est = np.where(
            valid[:, None] & (pdf[:, None] > 0),
            np.asarray(f) / np.maximum(pdf[:, None], 1e-9),
            0.0,
        )
        assert est.mean(0).max() < 1.05

    def test_absorption_darkens(self):
        """Nonzero sigma_a must strictly reduce the substrate response."""
        clear = self._make(rough=0.3)
        tinted = self._make(rough=0.3, sigma_a=(0.5, 0.5, 0.5))
        wo = jnp.broadcast_to(jnp.asarray(_wo(30)), (1, 3))
        wi = jnp.broadcast_to(jnp.asarray(_wo(-20)), (1, 3))
        f_c, _ = clear.evaluate(wo, wi)
        f_t, _ = tinted.evaluate(wo, wi)
        assert float(f_t.sum()) < float(f_c.sum())

    def test_internal_scattering_brightens_vs_naive(self):
        """The kd/(1-kd*Fdr) compensation must brighten the substrate over a
        plain (1-Fi)(1-Fo)/eta^2-scaled Lambert term for high-albedo kd."""
        from akari_render.svm.surface import fr_dielectric_integral

        eta = jnp.full((1,), 1.5)
        fdr = float(fr_dielectric_integral(eta)[0])
        # INTERNAL diffuse Fresnel reflectance: ~0.596 at eta=1.5 (light
        # bouncing inside the coat re-enters the substrate)
        assert 0.55 < fdr < 0.65
        kd = 0.9
        assert kd / (1 - kd * fdr) > kd


class TestStaticLobeElimination:
    """FusedPrincipled with static_zero flags must be BIT-exact vs the
    unspecialized closure when those parameters are in fact zero (the
    weighted-choice remap with probability 0 is the identity)."""

    def _make(self, static_zero):
        import jax.numpy as jnp

        from akari_render.svm.eval import build_principled_surface

        n = 512
        rng = np.random.default_rng(5)
        z = jnp.zeros(n)
        return build_principled_surface(
            color=jnp.asarray(rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)),
            emission=jnp.zeros((n, 3)),
            metallic=z,
            roughness=jnp.asarray(rng.uniform(0.1, 0.9, n).astype(np.float32)),
            eta=jnp.full(n, 1.45),
            transmission=z,
            specular_ior_level=jnp.full(n, 0.5),
            specular_tint=jnp.ones((n, 3)),
            coat_weight=z,
            coat_roughness=jnp.full(n, 0.1),
            coat_ior=jnp.full(n, 1.5),
            coat_tint=jnp.ones((n, 3)),
            fused=True,
            static_zero=static_zero,
        )

    def test_bit_exact(self):
        import jax.numpy as jnp

        full = self._make(frozenset())
        spec = self._make(frozenset({"metallic", "transmission", "coat"}))
        rng = np.random.default_rng(9)
        n = 512

        def dirs():
            v = rng.normal(size=(n, 3)).astype(np.float32)
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            v[:, 2] = np.abs(v[:, 2]) + 1e-3
            return jnp.asarray(v / np.linalg.norm(v, axis=-1, keepdims=True))

        wo, wi = dirs(), dirs()
        u_sel = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
        u_smp = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
        f1, p1 = full.evaluate(wo, wi)
        f2, p2 = spec.evaluate(wo, wi)
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        w1, v1 = full.sample_wi(wo, u_sel, u_smp)
        w2, v2 = spec.sample_wi(wo, u_sel, u_smp)
        np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(
            np.asarray(full.albedo(wo)), np.asarray(spec.albedo(wo))
        )
        np.testing.assert_array_equal(
            np.asarray(full.roughness(wo, u_sel)), np.asarray(spec.roughness(wo, u_sel))
        )
