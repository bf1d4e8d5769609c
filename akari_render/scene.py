"""Scene assembly: scenegraph JSON -> device-resident CompiledScene.

The analog of crates/akari_render/src/load.rs SceneLoader::{preload,
do_load}: flatten geometry, compile shader graphs into kinds + constant
table, detect emissive instances by per-triangle Monte Carlo emission power
(load.rs:312-343), build light alias tables, load the camera.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .accel.flatten import TriangleSoup, flatten_scene
from .camera import PerspectiveCamera, camera_from_scenegraph
from .core.math import Frame, normalize
from .lights import LightArrays
from .scenegraph.model import SceneGraph, load_scene_json
from .svm.compiler import CompiledKind, CompilerDriver
from .svm.eval import EvalContext, dispatch_closure, eval_kind
from .svm.surface import frame_from_n_t
from .svm.texture import TextureAtlas


class SceneArrays(NamedTuple):
    """Device pytree: everything the integrators touch per ray."""

    # geometry (flat world-space soup)
    v0: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray
    ng: jnp.ndarray
    area: jnp.ndarray
    ns: jnp.ndarray  # [T, 3, 3]
    uv: jnp.ndarray  # [T, 3, 2]
    tangent: jnp.ndarray  # [T, 3, 3] per-corner stored tangents (0 = dpdu)
    inst_id: jnp.ndarray
    # material binding
    shader_kind: jnp.ndarray  # [T] int32
    tri_mat: jnp.ndarray  # [T] int32 global material index
    param_mats: tuple  # per-kind [num_materials, kind_width] constant matrices
    # packed per-triangle attribute matrix for one-hot fetch (small scenes):
    # [T, 41] = v0 e1 e2 ng area ns(9) uv(6) tangent(9) kind mat light_id prim_pdf
    attr: jnp.ndarray
    # acceleration structure: None for small scenes (brute force wins),
    # else dict(bvh=BvhArrays, v0/e1/e2=triangles in BVH order)
    bvh: dict | None
    # per-material constant emission [M, 3], or None if any material's
    # emission is texture-driven (then the closure path is used). Constant
    # folding here removes two full shader-graph dispatches per bounce.
    const_emission: jnp.ndarray | None
    # lights
    lights: LightArrays
    # two-level instanced accel for repeated non-emissive geometry
    # (accel/instanced.py, ref mesh.rs:288-333 BLAS/TLAS), or None
    instanced: object = None


@dataclass
class Scene:
    """CompiledScene: static info (kinds, camera) + device arrays."""

    arrays: SceneArrays
    kinds: list[CompiledKind]
    camera: PerspectiveCamera
    atlas: TextureAtlas | None
    material_names: list[str]
    num_tris: int
    has_alpha: bool = False
    # per-kind "can this kind's alpha be < 1" verdict from the static
    # bytecode scan (None = unknown, evaluate all kinds)
    kind_alpha: list[bool] | None = None
    # per-kind [kind_width, 2] host min/max of every constant column over
    # the kind's materials — powers trace-time dead-lobe elimination
    kind_const_ranges: list | None = None

    # max triangle count for the one-hot-matmul attribute fetch; beyond this
    # the [N, T] one-hot outweighs gathers (BVH scenes use the gather path)
    ONE_HOT_MAX_TRIS = 2048
    # accel routing: below BVH_MIN_TRIS brute force (accel/brute_triton.py:
    # a Triton kernel on the GPU, XLA's [T, N] form elsewhere), above it
    # cluster culling (accel/cluster.py)
    BVH_MIN_TRIS = 32768

    def intersect(self, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None):
        """Closest-hit through whichever accel the scene carries
        (the rtx::Accel::intersect analog, scene.rs:111-153). Scenes with an
        instanced part min-combine the flat-soup hit with the two-level hit.
        Fused shadow lanes go through here too: their caller reads only
        `valid`, which closest-hit answers correctly."""
        hit = self._intersect_flat(o, d, tmin, tmax, exclude0, exclude1, exclude2)
        if self.arrays.instanced is None:
            return hit
        import jax

        from .accel.instanced import intersect_instanced

        with jax.named_scope("instanced"):
            hit_i = intersect_instanced(
                self.arrays.instanced, o, d, tmin, jnp.minimum(tmax, hit.t),
                exclude0, exclude1, exclude2,
            )
        better = hit_i.valid & (hit_i.t < hit.t)
        return jax.tree_util.tree_map(
            lambda a_, b_: jnp.where(
                better.reshape(better.shape + (1,) * (a_.ndim - 1)), b_, a_
            ),
            hit,
            hit_i,
        )

    def _intersect_flat(self, o, d, tmin, tmax, exclude0=None, exclude1=None,
                        exclude2=None):
        a = self.arrays
        if self.num_tris == 0:
            from .accel.trace import Hit

            n = o.shape[0]
            from .core.math import RAY_TMAX

            return Hit(
                t=jnp.full((n,), RAY_TMAX),
                tri_id=jnp.full((n,), -1, jnp.int32),
                bary=jnp.zeros((n, 2)),
                valid=jnp.zeros((n,), bool),
            )
        if a.bvh is None:
            from .accel.brute_triton import intersect_brute

            return intersect_brute(
                o, d, tmin, tmax, a.v0, a.e1, a.e2, exclude0, exclude1, exclude2
            )
        from .accel.cluster import intersect_clusters

        return intersect_clusters(
            a.bvh["clusters"], o, d, tmin, tmax, exclude0, exclude1, exclude2,
            any_hit=False,
        )

    # ---- stochastic alpha-tested traversal (scene.rs:42-110) ----
    # The reference's traversal loops until commit (scene.rs:49-86); the
    # while_loop here does the same with a deep safety bound — each restart
    # strictly advances past one rejected candidate, so 64 is only reached
    # by a ray crossing >64 rejecting surfaces, and those lanes are then
    # reported as MISS (treat-as-transparent) instead of silently committing
    # a hit the alpha test rejected.
    MAX_ALPHA_RESTARTS = 64


    def _alpha_at(self, si, n):
        """Per-lane alpha at an interaction; only kinds whose static scan says
        they CAN have alpha (image-textured base color) are evaluated —
        provably-opaque kinds contribute alpha = 1 for free."""
        from .svm.eval import dispatch_closure

        alpha = jnp.ones(n)
        for k, kind in enumerate(self.kinds):
            if self.kind_alpha is not None and not self.kind_alpha[k]:
                continue
            ctx = self.eval_context(si, k)
            a_k = dispatch_closure(kind, ctx, mode="alpha").alpha()
            alpha = jnp.where(si["kind"] == k, a_k, alpha)
        return alpha

    def intersect_alpha(self, o, d, tmin, tmax, exclude0=None, exclude1=None):
        """Closest-hit with stochastic alpha testing: candidates whose alpha
        rejects are skipped by restarting past them (SURVEY.md §7.3 item 5 —
        traversal restart instead of in-traversal callbacks). The accept
        decision hashes (tri, bary) exactly like the reference's
        hash-as-rng commit (scene.rs:49-86), so it is deterministic.

        The caller's exclusion ids stay active across every restart (the
        rejected candidate rides the third exclusion slot), and the restart
        loop is a lax.while_loop that exits as soon as no lane rejects —
        all-opaque hit batches pay exactly one alpha evaluation.
        """
        if not self.has_alpha:
            return self.intersect(o, d, tmin, tmax, exclude0, exclude1)
        import jax

        from .core.lds import _hash

        n = o.shape[0]

        def reject_of(hit):
            si = self.surface_interaction(jnp.maximum(hit.tri_id, 0), hit.bary)
            alpha = self._alpha_at(si, n)
            bb = jax.lax.bitcast_convert_type(hit.bary, jnp.uint32)
            u = (
                _hash(hit.tri_id.astype(jnp.uint32) ^ _hash(bb[..., 0]) ^ bb[..., 1])
                >> 8
            ).astype(jnp.float32) * (1.0 / (1 << 24))
            return hit.valid & (u >= alpha)

        hit = self.intersect(o, d, tmin, tmax, exclude0, exclude1)

        def cond(carry):
            i, _, reject = carry
            return (i < self.MAX_ALPHA_RESTARTS) & jnp.any(reject)

        def body(carry):
            i, hit, reject = carry
            # restart past the rejected hit; earlier rejected candidates sit
            # below the advanced tmin (strict t > tmin), so one extra slot
            # suffices and the caller's exclude0/1 stay in force. Lanes with
            # nothing to re-resolve trace with tmax = -1 (the sweep's
            # dead-lane horizon skips them for free).
            new_tmin = jnp.where(reject, hit.t, tmin)
            rehit = self.intersect(
                o, d, new_tmin, jnp.where(reject, tmax, -1.0),
                exclude0, exclude1, exclude2=hit.tri_id,
            )
            hit = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    reject.reshape(reject.shape + (1,) * (a.ndim - 1)), b, a
                ),
                hit,
                rehit,
            )
            return (i + 1, hit, reject_of(hit))

        _, hit, reject = jax.lax.while_loop(
            cond, body, (jnp.int32(0), hit, reject_of(hit))
        )
        # bound exhausted with a rejection still pending: report MISS rather
        # than commit the rejected candidate
        from .accel.trace import Hit
        from .core.math import RAY_TMAX

        return Hit(
            t=jnp.where(reject, RAY_TMAX, hit.t),
            tri_id=jnp.where(reject, -1, hit.tri_id),
            bary=hit.bary,
            valid=hit.valid & ~reject,
        )

    def occlude_alpha(self, o, d, tmin, tmax, exclude0=None, exclude1=None):
        """Any-hit with stochastic alpha (scene.rs:154-185 runs the same
        alpha-tested ray query for shadow rays). Opaque scenes use the fast
        any-hit. Alpha scenes STAGE it: a plain
        any-hit first resolves every unoccluded lane at opaque cost —
        nothing at all in the segment means nothing that could accept — and
        only lanes whose segment contains *some* surface walk the
        closest-hit restart chain to learn whether any candidate commits
        (the others ride along with tmax = -1, skipped by the sweep's
        dead-lane horizon). Typical NEE shadow batches are mostly
        unoccluded, so the expensive stage runs nearly empty."""
        if not self.has_alpha:
            return self.occlude(o, d, tmin, tmax, exclude0, exclude1)
        any_surf = self.occlude(o, d, tmin, tmax, exclude0, exclude1)
        hit = self.intersect_alpha(
            o, d, tmin, jnp.where(any_surf, tmax, -1.0), exclude0, exclude1
        )
        return any_surf & hit.valid

    def occlude(self, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None):
        """Any-hit (the rtx occlude analog, scene.rs:154-185)."""
        occ = self._occlude_flat(o, d, tmin, tmax, exclude0, exclude1, exclude2)
        if self.arrays.instanced is None:
            return occ
        import jax

        from .accel.instanced import intersect_instanced

        with jax.named_scope("instanced"):
            occ_i = intersect_instanced(
                self.arrays.instanced, o, d, tmin, tmax,
                exclude0, exclude1, exclude2, any_hit=True,
            )
        return occ | occ_i

    def _occlude_flat(self, o, d, tmin, tmax, exclude0=None, exclude1=None,
                      exclude2=None):
        a = self.arrays
        if self.num_tris == 0:
            return jnp.zeros((o.shape[0],), bool)
        if a.bvh is None:
            from .accel.brute_triton import occlude_brute

            return occlude_brute(
                o, d, tmin, tmax, a.v0, a.e1, a.e2, exclude0, exclude1, exclude2
            )
        from .accel.cluster import intersect_clusters

        return intersect_clusters(
            a.bvh["clusters"], o, d, tmin, tmax, exclude0, exclude1, exclude2,
            any_hit=True,
        )

    # ---- shading helpers used by all integrators ----
    def surface_interaction(self, tri_id, bary):
        """Fetch + interpolate hit attributes (ref mesh.rs:487-655).

        tri_id: [N] int32 (clamped), bary: [N, 2]. Returns dict with p, ng,
        ns, uv, frame(t,b,n), area, kind, mat, light_id, prim_pdf.

        Small scenes fetch ALL per-tri attributes with one one-hot matmul
        [N, T] @ [T, 41] instead of ~15 gathers.
        """
        import jax

        a = self.arrays
        t = jnp.maximum(tri_id, 0)
        b0 = bary[..., 0:1]
        b1 = bary[..., 1:2]
        if a.instanced is not None:
            si_i = self._si_instanced(t, b0, b1)
            if self.num_tris == 0:  # fully-instanced scene
                return si_i
            is_inst = t >= self.num_tris
            si_f = self._si_flat(jnp.minimum(t, self.num_tris - 1), b0, b1)
            si = jax.tree_util.tree_map(
                lambda x, y: jnp.where(
                    is_inst.reshape(is_inst.shape + (1,) * (x.ndim - 1)), y, x
                ),
                si_f,
                si_i,
            )
            si["tri_id"] = t
            return si
        return self._si_flat(t, b0, b1)

    def _si_flat(self, t, b0, b1):
        import jax

        a = self.arrays
        if self.num_tris <= self.ONE_HOT_MAX_TRIS:
            oh = jax.nn.one_hot(t, a.attr.shape[0], dtype=jnp.float32)
            # GEOMETRY goes through this matmul: full f32 precision, or
            # vertex positions quantize (terracing + corner seams)
            attr = jnp.matmul(oh, a.attr, precision=jax.lax.Precision.HIGHEST)
        else:
            # ONE packed [N, 41] row gather (contiguous 164 B per lane)
            # instead of 12 scattered per-attribute gathers
            attr = a.attr[t]
        v0 = attr[..., 0:3]
        e1 = attr[..., 3:6]
        e2 = attr[..., 6:9]
        ng = attr[..., 9:12]
        area = attr[..., 12]
        ns_c = attr[..., 13:22].reshape(attr.shape[:-1] + (3, 3))
        uv_c = attr[..., 22:28].reshape(attr.shape[:-1] + (3, 2))
        tan_c = attr[..., 28:37].reshape(attr.shape[:-1] + (3, 3))
        kind = attr[..., 37].astype(jnp.int32)
        mat = attr[..., 38].astype(jnp.int32)
        light_id = attr[..., 39].astype(jnp.int32)
        prim_pdf = attr[..., 40]
        return self._finish_si(
            t, b0, b1, v0, e1, e2, ng, area, ns_c, uv_c, tan_c,
            kind, mat, light_id, prim_pdf,
        )

    def _si_instanced(self, t, b0, b1):
        """Attribute fetch for global virtual tri ids >= num_tris: locate the
        instance by tri_base, gather LOCAL attributes, apply the instance
        transform at fetch time (the memory win of two-level instancing:
        per-instance world attributes are never materialized)."""
        import jax

        from .accel.instanced import apply_3x3, apply_affine, apply_linear

        ia = self.arrays.instanced
        num_i = ia.tri_base.shape[0]
        i = jnp.clip(jnp.searchsorted(ia.tri_base, t, side="right") - 1, 0, num_i - 1)
        tl_max = max(int(ia.v0.shape[0]) - 1, 0)
        lt = jnp.clip(t - ia.tri_base[i] + ia.mesh_tri_start[i], 0, tl_max)
        m = ia.m[i]
        mt = ia.minv_t[i]
        # ONE packed row gather (see InstancedArrays.attr_local layout)
        al = ia.attr_local[lt]
        l_v0, l_e1, l_e2 = al[..., 0:3], al[..., 3:6], al[..., 6:9]
        nsl = al[..., 9:18].reshape(al.shape[:-1] + (3, 3))
        uv_c = al[..., 18:24].reshape(al.shape[:-1] + (3, 2))
        tanl = al[..., 24:33].reshape(al.shape[:-1] + (3, 3))
        v0 = apply_affine(m, l_v0)
        e1 = apply_linear(m, l_e1)
        e2 = apply_linear(m, l_e2)
        ngl = jnp.cross(l_e1, l_e2)
        ng = apply_3x3(mt, ngl)
        ng = ng / jnp.maximum(
            jnp.sqrt(jnp.sum(ng * ng, -1, keepdims=True)), 1e-30
        )
        area = 0.5 * jnp.sqrt(jnp.sum(jnp.cross(e1, e2) ** 2, -1))
        ns_c = jnp.stack(
            [apply_3x3(mt, nsl[:, c, :]) for c in range(3)], axis=-2
        )
        ns_c = ns_c / jnp.maximum(
            jnp.sqrt(jnp.sum(ns_c * ns_c, -1, keepdims=True)), 1e-30
        )
        tan_c = jnp.stack(
            [apply_linear(m, tanl[:, c, :]) for c in range(3)], axis=-2
        )
        tlen = jnp.sqrt(jnp.sum(tan_c * tan_c, -1, keepdims=True))
        tan_c = jnp.where(tlen > 1e-12, tan_c / jnp.maximum(tlen, 1e-30), 0.0)
        slot = jnp.clip(al[..., 33].astype(jnp.int32), 0, ia.slot_mat.shape[1] - 1)
        mat = ia.slot_mat[i, slot]
        kind = ia.slot_kind[i, slot]
        light_id = jnp.full(t.shape, -1, jnp.int32)  # instanced = non-emissive
        prim_pdf = jnp.zeros(t.shape)
        return self._finish_si(
            t, b0, b1, v0, e1, e2, ng, area, ns_c, uv_c, tan_c,
            kind, mat, light_id, prim_pdf,
        )

    def _finish_si(self, t, b0, b1, v0, e1, e2, ng, area, ns_c, uv_c, tan_c,
                   kind, mat, light_id, prim_pdf):
        p = v0 + e1 * b0 + e2 * b1
        w0 = 1.0 - b0 - b1
        ns = normalize(w0 * ns_c[..., 0, :] + b0 * ns_c[..., 1, :] + b1 * ns_c[..., 2, :])
        uv = w0[..., :1] * uv_c[..., 0, :] + b0[..., :1] * uv_c[..., 1, :] + b1[..., :1] * uv_c[..., 2, :]
        # dpdu tangent (mesh.rs:552-592)
        duv02 = uv_c[..., 0, :] - uv_c[..., 2, :]
        duv12 = uv_c[..., 1, :] - uv_c[..., 2, :]
        dp02 = -e2  # v0 - v2
        dp12 = e1 - e2  # v1 - v2
        det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
        degenerate = jnp.abs(det) < 1e-8
        inv_det = jnp.where(degenerate, 0.0, 1.0 / jnp.where(degenerate, 1.0, det))
        tangent = (
            duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12
        ) * inv_det[..., None]
        tlen2 = jnp.sum(tangent * tangent, -1)
        fallback_t, _ = _onb(ng)
        tangent = jnp.where((degenerate | (tlen2 == 0.0))[..., None], fallback_t, tangent)
        # stored (mikktspace-style) per-corner tangents take precedence over
        # the dpdu fallback (ref mesh.rs:552-592); zero rows mean "none"
        tan_stored = (
            w0 * tan_c[..., 0, :] + b0 * tan_c[..., 1, :] + b1 * tan_c[..., 2, :]
        )
        stored_ok = jnp.sum(tan_stored * tan_stored, -1) > 1e-12
        tangent = jnp.where(stored_ok[..., None], tan_stored, tangent)
        frame = frame_from_n_t(ns, tangent)
        return {
            "p": p,
            "ng": ng,
            "ns": ns,
            "uv": uv,
            "frame": frame,
            "area": area,
            "kind": kind,
            "mat": mat,
            "light_id": light_id,
            "prim_pdf": prim_pdf,
            "tri_id": t,
        }

    def eval_context(self, si, kind_idx: int, lambda0=None) -> EvalContext:
        """Prefetch all per-lane shader constants with ONE one-hot matmul
        over the [M, width] constant table (M = materials is small)."""
        import jax

        mat_matrix = self.arrays.param_mats[kind_idx]
        n_mats = mat_matrix.shape[0]
        onehot = jax.nn.one_hot(si["mat"], n_mats, dtype=jnp.float32)
        params = jnp.matmul(onehot, mat_matrix, precision=jax.lax.Precision.HIGHEST)
        return EvalContext(
            params=params,
            uv=si["uv"],
            p=si["p"],
            ng=si["ng"],
            frame=si["frame"],
            textures=self.atlas,
            const_ranges=(
                self.kind_const_ranges[kind_idx]
                if self.kind_const_ranges is not None
                else None
            ),
            lambda0=lambda0,
        )

    @property
    def has_dispersion(self) -> bool:
        """Static: any shader kind holds a dispersive (Cauchy) glass node.
        Gates the spectral path's hero-collapse machinery so non-dispersive
        scenes trace the exact same graph as before."""
        cached = getattr(self, "_has_dispersion", None)
        if cached is None:
            from .svm.eval import kind_is_dispersive

            cached = any(kind_is_dispersive(k) for k in self.kinds)
            self._has_dispersion = cached
        return cached

    def dispatch_closures(self, si, lambda0=None):
        """Build one SurfaceClosure per shader kind plus the per-lane kind
        mask — the lax.switch-free analog of Svm::dispatch_surface
        (eval.rs:444-466): with K kinds we evaluate K closures on all lanes
        and the integrator blends results by mask. Returns list[(mask, closure)].
        """
        out = []
        for k, kind in enumerate(self.kinds):
            mask = si["kind"] == k
            ctx = self.eval_context(si, k, lambda0=lambda0)
            out.append((mask, dispatch_closure(kind, ctx, mode="surface")))
        return out


def _onb(n):
    from .core.math import orthonormal_basis

    return orthonormal_basis(n)


def _const_emission_table(sg: SceneGraph, mat_names: list[str]):
    """Per-material constant emission (linear RGB), or None if any material
    has texture/graph-driven emission or a nonzero clearcoat (which scales
    emission by 1 - E_coat). Mirrors the analytic fast path of
    _estimate_emission_const but keeps full RGB."""
    rows = []
    for name in mat_names:
        graph = sg.materials[name]["shader"]
        nodes = graph["nodes"]
        out = nodes[graph["output"]["id"]]
        node = nodes[out["node"]["id"]]

        def const_rgb(ref):
            n = nodes[ref["id"]]
            t = n["type"]
            if t == "spectral_uplift":
                return const_rgb(n["rgb"])
            if t == "float":
                v = float(n["value"])
                return [v, v, v]
            if t in ("float3", "rgb"):
                return [float(x) for x in n["value"]]
            return None

        if node["type"] == "principled":
            e = const_rgb(node["emission_color"])
            st = const_rgb(node["emission_strength"])
            cw = const_rgb(node["coat_weight"]) if "coat_weight" in node else [0, 0, 0]
            if e is None or st is None or cw is None or max(cw) != 0.0:
                return None
            rows.append([e[i] * st[0] for i in range(3)])
        elif node["type"] == "emission":
            e = const_rgb(node["color"])
            st = const_rgb(node["strength"])
            if e is None or st is None:
                return None
            rows.append([e[i] * st[0] for i in range(3)])
        else:
            rows.append([0.0, 0.0, 0.0])
    return jnp.asarray(np.asarray(rows, np.float32))


def _kind_may_have_alpha(kind, params: np.ndarray) -> bool:
    """Static bytecode + constant scan: non-unit alpha possible? (compile-time
    analog of the reference's always-on alpha eval — we skip the restart
    loop entirely for provably-opaque scenes). `params` is the kind's
    [materials, width] constant matrix."""
    # Alpha comes exclusively from the base-color texture's alpha channel
    # (principled.rs:15-26 ignores the `alpha` socket; diffuse.rs:85-92 uses
    # eval_color_alpha the same way). So the only alpha source is an image
    # node — decided at scene level by inspecting the atlas texels.
    del params
    for node in kind.nodes:
        if node[0] == "image":
            return "image"
    return "no"


# ---- loading ----------------------------------------------------------------
def _partition_instances(sg: SceneGraph):
    """Pick which instances go to the two-level instanced accel instead of
    being flattened: geometry referenced >= AKR_INSTANCE_MIN (default 2)
    times by non-emissive instances with >= AKR_INSTANCE_MIN_TRIS triangles.
    Emissive instances always flatten (light tables are per-world-triangle).
    AKR_INSTANCING=0 disables. Returns (skip names, instance specs, meshes)."""
    import os

    if os.environ.get("AKR_INSTANCING", "1") == "0":
        return set(), [], []
    min_refs = int(os.environ.get("AKR_INSTANCE_MIN", "2"))
    min_tris = int(os.environ.get("AKR_INSTANCE_MIN_TRIS", "128"))

    refcount: dict[str, int] = {}
    for inst in sg.instances.values():
        g = inst["geometry"]["id"]
        refcount[g] = refcount.get(g, 0) + 1

    from .accel.flatten import local_mesh_arrays
    from .scenegraph.model import load_transform

    skip: set[str] = set()
    specs: list[dict] = []
    meshes: list[dict] = []
    geom_slot: dict[str, int] = {}
    for idx, (name, inst) in enumerate(sg.instances.items()):
        g = inst["geometry"]["id"]
        if refcount[g] < min_refs:
            continue
        emissive = False
        for mref in inst["materials"]:
            e = _estimate_emission_const(sg.materials[mref["id"]]["shader"])
            if e is None or e > 0.0:
                emissive = True
                break
        if emissive:
            continue
        if g not in geom_slot:
            me = local_mesh_arrays(sg, g)
            if len(me["v0"]) < min_tris:
                refcount[g] = 0  # too small: flatten all its instances
                continue
            geom_slot[g] = len(meshes)
            meshes.append(me)
        skip.add(name)
        specs.append(
            {
                "name": name,
                "mesh": geom_slot[g],
                "matrix": load_transform(inst["transform"], is_camera=False),
                "materials": [m["id"] for m in inst["materials"]],
                "inst_index": idx,
            }
        )
    return skip, specs, meshes


def _estimate_emission_const(graph: dict) -> float | None:
    """Fast emission scan (load.rs:74-127): returns max emission*strength if
    statically known, None if texture-driven (conservatively emissive)."""
    nodes = graph["nodes"]
    out = nodes[graph["output"]["id"]]
    assert out["type"] == "output"
    node = nodes[out["node"]["id"]]

    def const_max(ref):
        n = nodes[ref["id"]]
        t = n["type"]
        if t == "spectral_uplift":
            return const_max(n["rgb"])
        if t == "float":
            return float(n["value"])
        if t in ("float3", "rgb"):
            return float(max(n["value"]))
        return None

    if node["type"] == "principled":
        e, s = const_max(node["emission_color"]), const_max(node["emission_strength"])
        # a non-zero clearcoat scales emission by (1 - E_coat) — needs MC
        cw = const_max(node["coat_weight"]) if "coat_weight" in node else 0.0
        if cw is None or cw != 0.0:
            return None
    elif node["type"] == "emission":
        e, s = const_max(node["color"]), const_max(node["strength"])
    else:
        return 0.0
    if e is None or s is None:
        return None  # needs MC estimate
    return e * s


def load_scene(path: str, width: int | None = None, height: int | None = None) -> Scene:
    # materialize precompute tables eagerly (never inside a jit trace) —
    # the reference does the same at load (svm.init_precompute_tables, load.rs:264)
    from .svm.precompute import get_table

    get_table("ggx_dielectric_s")
    sg = load_scene_json(path)
    skip, inst_specs, mesh_list = _partition_instances(sg)
    soup, mat_names, instance_info = flatten_scene(sg, skip=skip or None)
    num_tris = len(soup.v0)

    # compile materials
    driver = CompilerDriver()
    images, image_keys = _collect_images(sg)
    refs = {name: driver.compile(sg.materials[name]["shader"], image_keys) for name in mat_names}
    kinds = driver.kind_list

    tri_kind = np.array([refs[mat_names[m]].kind for m in soup.mat_id], np.int32)

    atlas = TextureAtlas.build(images) if images else None

    # acceleration structure for non-toy scenes
    import os

    bvh_field = None
    if num_tris >= Scene.BVH_MIN_TRIS or os.environ.get("AKR_FORCE_BVH"):
        from .accel.bvh import build_bvh
        from .accel.cluster import build_clusters

        bvh = build_bvh(soup.v0, soup.e1, soup.e2)
        bvh_field = {
            "clusters": build_clusters(soup.v0, soup.e1, soup.e2, np.asarray(bvh.order)),
        }

    # two-level instanced accel for repeated non-emissive geometry
    inst_arrays = None
    if inst_specs:
        from .accel.instanced import build_instanced

        name_to_idx = {n: i for i, n in enumerate(mat_names)}
        for spec in inst_specs:
            spec["slot_mat"] = [name_to_idx[m] for m in spec["materials"]] or [0]
            spec["slot_kind"] = [refs[m].kind for m in spec["materials"]] or [0]
        inst_arrays, _ = build_instanced(mesh_list, inst_specs, num_tris)

    placeholder_lights = LightArrays.build([], [], num_tris)
    arrays = SceneArrays(
        v0=jnp.asarray(soup.v0),
        e1=jnp.asarray(soup.e1),
        e2=jnp.asarray(soup.e2),
        ng=jnp.asarray(soup.ng),
        area=jnp.asarray(soup.area),
        ns=jnp.asarray(soup.ns),
        uv=jnp.asarray(soup.uv),
        tangent=jnp.asarray(soup.tangent),
        inst_id=jnp.asarray(soup.inst_id),
        shader_kind=jnp.asarray(tri_kind),
        tri_mat=jnp.asarray(soup.mat_id.astype(np.int32)),
        param_mats=tuple(jnp.asarray(m) for m in driver.param_matrices()),
        attr=_build_attr(soup, tri_kind, placeholder_lights),
        bvh=bvh_field,
        const_emission=_const_emission_table(sg, mat_names),
        lights=placeholder_lights,  # rebuilt below once emission is known
        instanced=inst_arrays,
    )
    # static alpha scan (decides whether traversal needs the restart loop)
    verdicts = [
        _kind_may_have_alpha(k, np.asarray(m))
        for k, m in zip(kinds, driver.param_matrices())
    ]
    has_alpha = any(v == "yes" for v in verdicts)
    if not has_alpha and any(v == "image" for v in verdicts) and atlas is not None:
        has_alpha = float(np.asarray(atlas.data[..., 3]).min()) < 1.0

    scene = Scene(
        arrays=arrays,
        kinds=kinds,
        camera=camera_from_scenegraph(sg.camera, width, height),
        atlas=atlas,
        material_names=mat_names,
        num_tris=num_tris,
        has_alpha=has_alpha,
        kind_alpha=[v != "no" for v in verdicts],
        kind_const_ranges=[
            np.stack([m.min(axis=0), m.max(axis=0)], axis=-1)
            for m in (np.asarray(pm) for pm in driver.param_matrices())
        ],
    )

    # ---- emissive detection + per-triangle power (load.rs:312-414) ----
    light_powers, light_tris = [], []
    areas_np = soup.area
    for info in instance_info:
        emissive = False
        needs_mc = False
        const_power = 0.0
        for mname in info["materials"]:
            e = _estimate_emission_const(sg.materials[mname]["shader"])
            if e is None:
                needs_mc = True
                emissive = True
            elif e > 0:
                emissive = True
                const_power = max(const_power, e)
        if not emissive:
            continue
        s, c = info["tri_start"], info["tri_count"]
        tri_ids = np.arange(s, s + c, dtype=np.int32)
        if needs_mc:
            powers = _mc_emission_power(scene, tri_ids, n_samples=16)
        else:
            # constant emission: the MC estimate reduces exactly to
            # max_rgb(emission) * area per triangle — skip the device pass
            per_mat = np.array(
                [
                    _estimate_emission_const(sg.materials[mat_names[m]]["shader"]) or 0.0
                    for m in soup.mat_id[s : s + c]
                ]
            )
            powers = (per_mat * areas_np[s : s + c]).astype(np.float64)
        total = float(powers.sum())
        if total > 1e-4:
            light_powers.append(powers)
            light_tris.append(tri_ids)

    lights = LightArrays.build(light_powers, light_tris, num_tris)
    attr = _build_attr(soup, tri_kind, lights)
    if lights.num_lights > 0:
        # compact NEE table (lights.light_point_attrs): the 13 geometry
        # columns + the material id, at the light-table rows. Light tris are
        # always flat-soup ids (emissive geometry is excluded from
        # instancing), so attr rows exist for every entry.
        rows = np.asarray(attr)[np.asarray(lights.tri_ids)]
        # mat ids ride column 13 as float32 (one packed row fetch); exact
        # only below 2^24 (guard at build so a pathological
        # material count fails loudly here, not as a wrong NEE emission)
        assert rows[:, 38].max(initial=0.0) < float(1 << 24), (
            "compact light table: material id exceeds float32 exactness"
        )
        lights = lights._replace(
            attr=jnp.asarray(
                np.concatenate([rows[:, :13], rows[:, 38:39]], axis=1),
                dtype=jnp.float32,
            )
        )
    scene.arrays = arrays._replace(lights=lights, attr=attr)
    return scene


def _build_attr(soup: TriangleSoup, tri_kind: np.ndarray, lights: LightArrays) -> jnp.ndarray:
    """Pack all per-triangle attributes into one [T, 41] matrix for the
    one-hot-matmul fetch path of surface_interaction."""
    T = len(soup.v0)
    cols = [
        soup.v0,
        soup.e1,
        soup.e2,
        soup.ng,
        soup.area[:, None],
        soup.ns.reshape(T, 9),
        soup.uv.reshape(T, 6),
        soup.tangent.reshape(T, 9),
        tri_kind[:, None].astype(np.float32),
        soup.mat_id[:, None].astype(np.float32),
        np.asarray(lights.tri_light_id)[:, None].astype(np.float32),
        np.asarray(lights.tri_prim_pdf)[:, None],
    ]
    return jnp.asarray(np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1))


def _mc_emission_power(scene: Scene, tri_ids: np.ndarray, n_samples: int = 16) -> np.ndarray:
    """Per-triangle emission power: mean over sampled points of
    max_rgb(closure.emission(wo)) * prim_area (load.rs:312-343)."""
    from .core.samplers import IndependentSampler
    from .core.sampling import cos_sample_hemisphere, uniform_sample_triangle

    m = len(tri_ids)
    tri = jnp.asarray(np.repeat(tri_ids, n_samples))
    lanes = jnp.arange(m * n_samples, dtype=jnp.uint32)
    smp = IndependentSampler.new(lanes, seed=1)
    smp, u_tri = smp.next_2d()
    smp, u_dir = smp.next_2d()
    bary = uniform_sample_triangle(u_tri)
    si = scene.surface_interaction(tri, bary)
    wo_local = cos_sample_hemisphere(u_dir)
    t, b, n = si["frame"]
    wo = Frame.to_world(t, b, n, wo_local)
    acc = jnp.zeros(m * n_samples)
    for mask, closure in scene.dispatch_closures(si):
        e = closure.emission(wo)
        acc = jnp.where(mask, jnp.max(e, axis=-1), acc)
    power = acc * si["area"]
    return np.asarray(power.reshape(m, n_samples).mean(axis=1), np.float64)


def _collect_images(sg: SceneGraph):
    """Decode all image-texture buffers referenced by shader graphs
    (load.rs:457-618). Returns (list of [h,w,4] float arrays, key->index)."""
    from .svm.compiler import _image_key

    keys: dict = {}
    images: list[np.ndarray] = []
    for mat in sg.materials.values():
        for node in mat["shader"]["nodes"].values():
            if node.get("type") != "image":
                continue
            img = node["image"]
            key = _image_key(img)
            if key in keys:
                continue
            keys[key] = len(images)
            images.append(_decode_image(sg, img))
    return images, keys


def _decode_image(sg: SceneGraph, img: dict) -> np.ndarray:
    """Decode one image node's buffer into [h, w, 4] float32 (raw values;
    sRGB decode happens at sample time per the shader's colorspace).
    Formats mirror the reference's ImageFormat enum (scenegraph scene.rs:
    299-311): raw float, exr through the self-contained EXR codec, png
    through the self-contained PNG decoder. jpeg/tiff/tga/dds need PIL.
    Images are stored v-flipped to match the reference (load.rs:599 flipv)."""
    data = sg.buffer_view(img["data"], np.uint8)
    fmt = img.get("format", "png")
    if fmt == "float":
        w, h, c = int(img["width"]), int(img["height"]), int(img.get("channels", 4))
        arr = np.frombuffer(data.tobytes(), np.float32).reshape(h, w, c)
        if c < 4:
            pad = np.concatenate(
                [np.zeros((h, w, 3 - c), np.float32), np.ones((h, w, 1), np.float32)], -1
            ) if c < 3 else np.ones((h, w, 1), np.float32)
            arr = np.concatenate([arr, pad[..., : 4 - c]], -1) if c < 4 else arr
    elif fmt == "exr":
        from .core.image_io import read_exr_bytes

        rgb = read_exr_bytes(data.tobytes()).astype(np.float32)
        if rgb.shape[-1] >= 4:
            arr = rgb[..., :4]
        else:
            h, w = rgb.shape[:2]
            pad = np.ones((h, w, 4 - rgb.shape[-1]), np.float32)
            arr = np.concatenate([rgb, pad], -1)
    elif fmt == "png":
        from .core.image_io import read_png_bytes

        arr = read_png_bytes(data.tobytes()).astype(np.float32) / 255.0
    else:  # jpeg / tiff / tga / dds (8-bit LDR family)
        arr = _decode_with_pil(data.tobytes(), fmt)
    return arr[::-1].copy()  # flip v


def _decode_with_pil(raw: bytes, fmt: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{fmt} image textures need PIL, which is not installed "
            "(png, exr and raw float textures decode without it)"
        ) from None
    import io

    pil = Image.open(io.BytesIO(raw)).convert("RGBA")
    return np.asarray(pil, np.float32) / 255.0
