"""Acceleration-structure tests: BVH build + cluster intersection vs brute
force ground truth (SURVEY.md §7.2 step 3: "validate against brute-force")."""
import jax.numpy as jnp
import numpy as np
import pytest

from akari_render.accel.bvh import _build_bvh_py, build_bvh, traverse
from akari_render.accel.cluster import build_clusters, intersect_clusters
from akari_render.accel.trace import intersect_brute_force, occlude_brute_force


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(7)
    T = 5000
    c = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
    return (
        c,
        rng.normal(0, 0.2, (T, 3)).astype(np.float32),
        rng.normal(0, 0.2, (T, 3)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    N = 2048
    o = jnp.asarray(rng.uniform(-8, 8, (N, 3)).astype(np.float32))
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d), jnp.zeros(N), jnp.full(N, 1e20)


def _ground_truth(soup, rays):
    v0, e1, e2 = (jnp.asarray(a) for a in soup)
    o, d, tmin, tmax = rays
    return intersect_brute_force(o, d, tmin, tmax, v0, e1, e2)


class TestBvh:
    def test_native_matches_python_builder(self, soup):
        v0, e1, e2 = soup
        from akari_render.native import get_lib

        if get_lib() is None:
            pytest.skip("native builder unavailable")
        nat = build_bvh(v0, e1, e2)
        py = _build_bvh_py(v0, e1, e2)
        # different trees are fine; both must be complete permutations
        assert sorted(np.asarray(nat.order).tolist()) == list(range(len(v0)))
        assert sorted(np.asarray(py.order).tolist()) == list(range(len(v0)))

    def test_traverse_matches_brute(self, soup, rays):
        v0, e1, e2 = soup
        bvh = build_bvh(v0, e1, e2)
        jv = [jnp.asarray(a)[bvh.order] for a in soup]
        o, d, tmin, tmax = rays
        ht = traverse(bvh, *jv, o, d, tmin, tmax)
        hb = _ground_truth(soup, rays)
        np.testing.assert_array_equal(np.asarray(ht.valid), np.asarray(hb.valid))
        np.testing.assert_allclose(np.asarray(ht.t), np.asarray(hb.t), rtol=1e-4)


class TestClusters:
    def test_intersect_matches_brute(self, soup, rays):
        v0, e1, e2 = soup
        bvh = build_bvh(v0, e1, e2)
        cl = build_clusters(v0, e1, e2, np.asarray(bvh.order))
        o, d, tmin, tmax = rays
        hc = intersect_clusters(cl, o, d, tmin, tmax)
        hb = _ground_truth(soup, rays)
        np.testing.assert_array_equal(np.asarray(hc.valid), np.asarray(hb.valid))
        np.testing.assert_allclose(np.asarray(hc.t), np.asarray(hb.t), rtol=1e-4)
        same = np.asarray(hc.tri_id) == np.asarray(hb.tri_id)
        assert same.mean() > 0.999  # coplanar-tie tri ids may differ

    def test_occlusion_matches_brute(self, soup, rays):
        v0, e1, e2 = soup
        bvh = build_bvh(v0, e1, e2)
        cl = build_clusters(v0, e1, e2, np.asarray(bvh.order))
        o, d, tmin, _ = rays
        tmax = jnp.full(o.shape[0], 4.0)
        occ_c = intersect_clusters(cl, o, d, tmin, tmax, any_hit=True)
        jv0, je1, je2 = (jnp.asarray(a) for a in soup)
        occ_b = occlude_brute_force(o, d, tmin, tmax, jv0, je1, je2)
        np.testing.assert_array_equal(np.asarray(occ_c), np.asarray(occ_b))

    def test_exclusion_ids(self, soup, rays):
        v0, e1, e2 = soup
        bvh = build_bvh(v0, e1, e2)
        cl = build_clusters(v0, e1, e2, np.asarray(bvh.order))
        o, d, tmin, tmax = rays
        h1 = intersect_clusters(cl, o, d, tmin, tmax)
        # excluding each ray's hit triangle must never return it again
        ex = h1.tri_id
        h2 = intersect_clusters(cl, o, d, tmin, tmax, exclude0=ex)
        both_valid = np.asarray(h1.valid) & np.asarray(h2.valid)
        assert (np.asarray(h1.tri_id)[both_valid] != np.asarray(h2.tri_id)[both_valid]).all()


class TestSceneWithAccel:
    def test_cbox_renders_identically_with_clusters(self, cbox_path):
        import os

        from akari_render.config import PTConfig
        from akari_render.integrators.pt import render_pt
        from akari_render.scene import load_scene

        s1 = load_scene(cbox_path, width=16, height=16)
        img1, _ = render_pt(s1, PTConfig(spp=4, max_depth=3, spp_per_pass=4))
        os.environ["AKR_FORCE_BVH"] = "1"
        try:
            s2 = load_scene(cbox_path, width=16, height=16)
            assert s2.arrays.bvh is not None
            img2, _ = render_pt(s2, PTConfig(spp=4, max_depth=3, spp_per_pass=4))
        finally:
            del os.environ["AKR_FORCE_BVH"]
        np.testing.assert_allclose(img1, img2, atol=1e-4)


class TestBruteTriton:
    """The brute-force Pallas kernel (Triton route), run in interpret mode,
    against the XLA brute force; the scene's brute tier on the CPU takes
    the XLA branch of the platform decision bit for bit."""

    def _case(self, seed, T, n, tmax):
        rng = np.random.default_rng(seed)
        v0 = jnp.asarray(rng.uniform(-3, 3, (T, 3)), jnp.float32)
        e1 = jnp.asarray(rng.uniform(-0.8, 0.8, (T, 3)), jnp.float32)
        e2 = jnp.asarray(rng.uniform(-0.8, 0.8, (T, 3)), jnp.float32)
        o = jnp.asarray(rng.uniform(-4, 4, (n, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        ex0 = jnp.asarray(rng.integers(-1, T, n), jnp.int32)
        return (o, d, jnp.zeros((n,)), jnp.full((n,), tmax), v0, e1, e2, ex0)

    @pytest.mark.parametrize("T,n,tmax", [(36, 256, 1e20), (200, 300, 1e20),
                                          (45, 77, 3.0)])
    def test_closest_matches_brute_force(self, T, n, tmax):
        from akari_render.accel.brute_triton import intersect_brute_triton

        o, d, tmin, tm, v0, e1, e2, ex0 = self._case(T, T, n, tmax)
        ref = intersect_brute_force(o, d, tmin, tm, v0, e1, e2, ex0)
        got = intersect_brute_triton(o, d, tmin, tm, v0, e1, e2, ex0,
                                     interpret=True)
        np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
        np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(ref.tri_id))
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got.bary), np.asarray(ref.bary),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("T", [36, 150])
    def test_any_hit_matches_brute_force(self, T):
        from akari_render.accel.brute_triton import intersect_brute_triton

        o, d, tmin, tm, v0, e1, e2, ex0 = self._case(7 * T, T, 200, 4.0)
        ref = occlude_brute_force(o, d, tmin, tm, v0, e1, e2, ex0)
        got = intersect_brute_triton(o, d, tmin, tm, v0, e1, e2, ex0,
                                     any_hit=True, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    @pytest.mark.parametrize("any_hit", [False, True])
    def test_cpu_takes_the_xla_branch(self, any_hit):
        import jax

        from akari_render.accel.brute_triton import intersect_brute, occlude_brute

        args = self._case(3, 60, 128, 5.0)
        if any_hit:
            got = jax.jit(occlude_brute)(*args)
            ref = jax.jit(occlude_brute_force)(*args)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        else:
            got = jax.jit(intersect_brute)(*args)
            ref = jax.jit(intersect_brute_force)(*args)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestSuperclusters:
    """Hierarchical supercluster cull (cluster.py::_intersect_super) must be
    exact: same hits as the flat cluster rounds and the brute force."""

    @pytest.fixture(autouse=True)
    def _small_groups(self, monkeypatch):
        from akari_render.accel import cluster as cm

        monkeypatch.setattr(cm, "SUPER_GROUP", 8)
        monkeypatch.setattr(cm, "SUPER_MIN_CLUSTERS", 16)
        monkeypatch.setenv("AKR_SUPERCLUSTERS", "1")  # opt-in path under test

    def _build(self, soup):
        v0, e1, e2 = soup
        bvh = build_bvh(v0, e1, e2)
        return build_clusters(v0, e1, e2, np.asarray(bvh.order))

    def test_level_built(self, soup):
        cl = self._build(soup)
        assert cl.sc_bmin is not None
        assert cl.cl_bounds.shape[1] == 8

    def test_matches_brute(self, soup, rays):
        cl = self._build(soup)
        o, d, tmin, tmax = rays
        hs = intersect_clusters(cl, o, d, tmin, tmax)
        hb = _ground_truth(soup, rays)
        np.testing.assert_array_equal(np.asarray(hs.valid), np.asarray(hb.valid))
        np.testing.assert_allclose(
            np.asarray(hs.t)[np.asarray(hb.valid)],
            np.asarray(hb.t)[np.asarray(hb.valid)],
            rtol=1e-4,
        )

    def test_matches_flat_rounds(self, soup, rays, monkeypatch):
        import os

        cl = self._build(soup)
        o, d, tmin, tmax = rays
        hs = intersect_clusters(cl, o, d, tmin, tmax)
        monkeypatch.setenv("AKR_SUPERCLUSTERS", "0")
        hf = intersect_clusters(cl, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(hs.valid), np.asarray(hf.valid))
        np.testing.assert_allclose(np.asarray(hs.t), np.asarray(hf.t), rtol=1e-5)

    def test_occlusion_and_exclusion(self, soup, rays):
        cl = self._build(soup)
        o, d, tmin, tmax = rays
        occ_s = intersect_clusters(cl, o, d, tmin, jnp.full(o.shape[0], 4.0), any_hit=True)
        jv0, je1, je2 = (jnp.asarray(a) for a in soup)
        occ_b = occlude_brute_force(o, d, tmin, jnp.full(o.shape[0], 4.0), jv0, je1, je2)
        np.testing.assert_array_equal(np.asarray(occ_s), np.asarray(occ_b))
        h1 = intersect_clusters(cl, o, d, tmin, tmax)
        h2 = intersect_clusters(cl, o, d, tmin, tmax, exclude0=h1.tri_id)
        bv = np.asarray(h1.valid) & np.asarray(h2.valid)
        assert (np.asarray(h1.tri_id)[bv] != np.asarray(h2.tri_id)[bv]).all()
