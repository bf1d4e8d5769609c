"""Two-level instanced acceleration: TLAS over instance AABBs routing into
shared per-mesh cluster structures in LOCAL space.

The analog of the reference's BLAS-per-mesh + instance-transform
TLAS (crates/akari_render/src/mesh.rs:288-333): N instances of an M-triangle
mesh cost O(M) device memory for geometry plus O(N) for transforms, instead of the
O(N*M) world-space soup of accel/flatten.py.

Traversal is the same dense round pattern as accel/cluster.py, one level up:
1. slab-test every ray against every instance's world AABB ([I, N] dense),
2. per ray, walk instances in entry order (lexicographic (entry, id)
   threshold rounds — exact, like clusters),
3. for each selected instance, transform the ray into mesh-local space
   (t parameter is preserved because the local direction is NOT normalized)
   and run the cluster traversal restricted to that mesh's cluster range
   (intersect_clusters crange=), then remap local tri ids to global virtual
   ids: tri_base[inst] + (local_tri - mesh_tri_start[inst]).

Exclusion ids arrive in global virtual space and are converted per lane;
ids outside the selected instance's range become -1 (no exclusion).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import HIGHEST, RAY_TMAX
from .cluster import CLUSTER_SIZE, ClusterArrays, build_clusters, intersect_clusters

SELECT_I = 4  # instances tested per round per ray


class InstancedArrays(NamedTuple):
    # ---- TLAS (per instance, [I, ...]) ----
    ibmin: jnp.ndarray  # [I, 3] world AABB
    ibmax: jnp.ndarray  # [I, 3]
    m: jnp.ndarray  # [I, 12] local->world affine rows (3x4)
    minv: jnp.ndarray  # [I, 12] world->local affine rows
    minv_t: jnp.ndarray  # [I, 9] inverse-transpose 3x3 (normal transform)
    tri_base: jnp.ndarray  # [I] first global virtual tri id
    tri_count: jnp.ndarray  # [I] mesh tri count
    mesh_tri_start: jnp.ndarray  # [I] local-soup start of this instance's mesh
    cluster_lo: jnp.ndarray  # [I] first local cluster id of the mesh
    cluster_hi: jnp.ndarray  # [I] one-past-last
    inst_index: jnp.ndarray  # [I] scene instance index (for si["inst_id"])
    # ---- local geometry (concatenated unique meshes) ----
    clusters: ClusterArrays
    v0: jnp.ndarray  # [Tl, 3] local
    e1: jnp.ndarray
    e2: jnp.ndarray
    ns: jnp.ndarray  # [Tl, 3, 3] local per-corner shading normals
    uv: jnp.ndarray  # [Tl, 3, 2]
    tangent: jnp.ndarray  # [Tl, 3, 3] local per-corner tangents (0 = dpdu)
    mat_slot: jnp.ndarray  # [Tl] local material slot index
    slot_mat: jnp.ndarray  # [I, S] slot -> global material id
    slot_kind: jnp.ndarray  # [I, S] slot -> shader kind
    # packed fetch matrix [Tl, 34]: v0|e1|e2|ns(9)|uv(6)|tangent(9)|mat_slot —
    # ONE contiguous row gather per lane at interaction time instead of 7
    # scattered per-attribute gathers
    attr_local: jnp.ndarray | None = None


def _affine_rows(mat: np.ndarray) -> np.ndarray:
    """4x4 -> flattened 3x4 rows [12]."""
    return np.asarray(mat, np.float64)[:3, :4].reshape(12).astype(np.float32)


def apply_affine(rows, p):
    """rows: [N, 12] (3x4); p: [N, 3] -> R @ p + t."""
    r = rows.reshape(rows.shape[0], 3, 4)
    return jnp.einsum("nij,nj->ni", r[:, :, :3], p, precision=HIGHEST) + r[:, :, 3]


def apply_linear(rows, v):
    r = rows.reshape(rows.shape[0], 3, 4)
    return jnp.einsum("nij,nj->ni", r[:, :, :3], v, precision=HIGHEST)


def apply_3x3(rows9, v):
    r = rows9.reshape(rows9.shape[0], 3, 3)
    return jnp.einsum("nij,nj->ni", r, v, precision=HIGHEST)


def build_instanced(meshes: list[dict], instances: list[dict], tri_base0: int):
    """meshes: [{v0,e1,e2,ns,uv,tangent,mat_slot}] local numpy arrays.
    instances: [{mesh: idx, matrix: 4x4, slot_mat: [S], slot_kind: [S],
    inst_index: int}]. tri_base0: first global virtual id (= num flat tris).
    """
    # concatenate local meshes; build clusters per mesh so no cluster spans
    # two meshes (cluster ranges stay per-mesh contiguous)
    from .bvh import build_bvh

    offs, cl_offs = [], []
    cat = {k: [] for k in ("v0", "e1", "e2", "ns", "uv", "tangent", "mat_slot")}
    all_cbmin, all_cbmax, all_tri, all_order = [], [], [], []
    tstart = 0
    cstart = 0
    for me in meshes:
        T = len(me["v0"])
        order = (
            np.asarray(build_bvh(me["v0"], me["e1"], me["e2"]).order)
            if T > CLUSTER_SIZE
            else np.arange(T)
        )
        cl = build_clusters(me["v0"], me["e1"], me["e2"], order)
        # local tri ids inside cluster rows are mesh-local; shift to soup-local
        tri = np.array(cl.tri)  # writable copy
        ids = tri[..., 9]
        tri[..., 9] = np.where(ids >= 0, ids + tstart, ids)
        all_cbmin.append(np.asarray(cl.cbmin))
        all_cbmax.append(np.asarray(cl.cbmax))
        all_tri.append(tri)
        offs.append(tstart)
        cl_offs.append((cstart, cstart + tri.shape[0]))
        cstart += tri.shape[0]
        tstart += T
        for k in cat:
            cat[k].append(me[k])
    clusters = ClusterArrays(
        cbmin=jnp.asarray(np.concatenate(all_cbmin)),
        cbmax=jnp.asarray(np.concatenate(all_cbmax)),
        tri=jnp.asarray(np.concatenate(all_tri)),
        order=jnp.zeros((0,), jnp.int32),  # unused in instanced mode
    )

    S = max(len(i["slot_mat"]) for i in instances)
    rows_m, rows_minv, rows_minvt = [], [], []
    ibmin, ibmax = [], []
    tri_bases, tri_counts, mesh_starts, cl_lo, cl_hi, inst_idx = [], [], [], [], [], []
    slot_mat = np.zeros((len(instances), S), np.int32)
    slot_kind = np.zeros((len(instances), S), np.int32)
    vbase = tri_base0
    for ii, inst in enumerate(instances):
        mi = inst["mesh"]
        me = meshes[mi]
        mat = np.asarray(inst["matrix"], np.float64)
        rows_m.append(_affine_rows(mat))
        inv = np.linalg.inv(mat)
        rows_minv.append(_affine_rows(inv))
        rows_minvt.append(inv[:3, :3].T.reshape(9).astype(np.float32))
        # world AABB: transform the local AABB's 8 corners
        lo = np.minimum(
            np.minimum(me["v0"], me["v0"] + me["e1"]), me["v0"] + me["e2"]
        ).min(0)
        hi = np.maximum(
            np.maximum(me["v0"], me["v0"] + me["e1"]), me["v0"] + me["e2"]
        ).max(0)
        corners = np.stack(
            [np.where([(c >> b) & 1 for b in range(3)], hi, lo) for c in range(8)]
        )
        wc = corners @ mat[:3, :3].T + mat[:3, 3]
        ibmin.append(wc.min(0).astype(np.float32))
        ibmax.append(wc.max(0).astype(np.float32))
        T = len(me["v0"])
        tri_bases.append(vbase)
        tri_counts.append(T)
        mesh_starts.append(offs[mi])
        cl_lo.append(cl_offs[mi][0])
        cl_hi.append(cl_offs[mi][1])
        inst_idx.append(inst["inst_index"])
        sm = np.asarray(inst["slot_mat"], np.int32)
        slot_mat[ii, : len(sm)] = sm
        slot_mat[ii, len(sm):] = sm[0] if len(sm) else 0
        sk = np.asarray(inst["slot_kind"], np.int32)
        slot_kind[ii, : len(sk)] = sk
        slot_kind[ii, len(sk):] = sk[0] if len(sk) else 0
        vbase += T

    return (
        InstancedArrays(
            ibmin=jnp.asarray(np.stack(ibmin)),
            ibmax=jnp.asarray(np.stack(ibmax)),
            m=jnp.asarray(np.stack(rows_m)),
            minv=jnp.asarray(np.stack(rows_minv)),
            minv_t=jnp.asarray(np.stack(rows_minvt)),
            tri_base=jnp.asarray(np.asarray(tri_bases, np.int32)),
            tri_count=jnp.asarray(np.asarray(tri_counts, np.int32)),
            mesh_tri_start=jnp.asarray(np.asarray(mesh_starts, np.int32)),
            cluster_lo=jnp.asarray(np.asarray(cl_lo, np.int32)),
            cluster_hi=jnp.asarray(np.asarray(cl_hi, np.int32)),
            inst_index=jnp.asarray(np.asarray(inst_idx, np.int32)),
            clusters=clusters,
            v0=jnp.asarray(np.concatenate(cat["v0"]).astype(np.float32)),
            e1=jnp.asarray(np.concatenate(cat["e1"]).astype(np.float32)),
            e2=jnp.asarray(np.concatenate(cat["e2"]).astype(np.float32)),
            ns=jnp.asarray(np.concatenate(cat["ns"]).astype(np.float32)),
            uv=jnp.asarray(np.concatenate(cat["uv"]).astype(np.float32)),
            tangent=jnp.asarray(np.concatenate(cat["tangent"]).astype(np.float32)),
            mat_slot=jnp.asarray(np.concatenate(cat["mat_slot"]).astype(np.int32)),
            slot_mat=jnp.asarray(slot_mat),
            slot_kind=jnp.asarray(slot_kind),
            attr_local=jnp.asarray(
                np.concatenate(
                    [
                        np.concatenate(cat["v0"]).astype(np.float32),
                        np.concatenate(cat["e1"]).astype(np.float32),
                        np.concatenate(cat["e2"]).astype(np.float32),
                        np.concatenate(cat["ns"]).astype(np.float32).reshape(-1, 9),
                        np.concatenate(cat["uv"]).astype(np.float32).reshape(-1, 6),
                        np.concatenate(cat["tangent"]).astype(np.float32).reshape(-1, 9),
                        np.concatenate(cat["mat_slot"]).astype(np.float32)[:, None],
                    ],
                    axis=1,
                )
            ),
        ),
        vbase,
    )


def _inst_entries(ia: InstancedArrays, o, d, tmin, tmax):
    """Entry distance per (instance, ray): [I, N]; +inf on miss."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    t0 = (ia.ibmin[:, None, :] - o[None, :, :]) * inv_d[None, :, :]
    t1 = (ia.ibmax[:, None, :] - o[None, :, :]) * inv_d[None, :, :]
    tn = jnp.minimum(t0, t1).max(-1)
    tf = jnp.maximum(t0, t1).min(-1)
    near = jnp.maximum(tn, tmin[None, :])
    far = jnp.minimum(tf, tmax[None, :])
    return jnp.where(near <= far, near, jnp.inf)


def intersect_instanced(ia: InstancedArrays, o, d, tmin, tmax,
                        exclude0=None, exclude1=None, exclude2=None,
                        any_hit=False):
    """Closest-hit (or any-hit) through the two-level structure. Returns a
    Hit with GLOBAL VIRTUAL tri ids (tri_base-mapped), or occluded [N]."""
    n = o.shape[0]
    num_inst = ia.ibmin.shape[0]
    t_best0 = jnp.minimum(jnp.full((n,), RAY_TMAX), tmax)
    excludes = (exclude0, exclude1, exclude2)

    def select_insts(t_best, thresh_e, thresh_id, m):
        e = _inst_entries(ia, o, d, tmin, t_best).T  # [N, I]
        ids_row = jnp.broadcast_to(
            jnp.arange(num_inst, dtype=jnp.int32)[None, :], e.shape
        )
        after = (e > thresh_e[:, None]) | (
            (e == thresh_e[:, None]) & (ids_row > thresh_id[:, None])
        )
        e = jnp.where(after, e, jnp.inf)
        sel_e, sel_i = [], []
        taken = jnp.zeros_like(e, bool)
        rows = jnp.arange(n)
        for _ in range(m):
            em = jnp.where(taken, jnp.inf, e)
            am = jnp.argmin(em, axis=1)
            sel_e.append(em[rows, am])
            sel_i.append(am.astype(jnp.int32))
            taken = taken | (ids_row == am[:, None].astype(jnp.int32))
        return jnp.stack(sel_e, 1), jnp.stack(sel_i, 1)

    def test_instance(iid, t_best, gtri, u, v, occ):
        """Cluster-traverse one per-lane instance (iid [N], -1 = skip)."""
        safe = jnp.maximum(iid, 0)
        live = iid >= 0
        o_l = apply_affine(ia.minv[safe], o)
        d_l = apply_linear(ia.minv[safe], d)
        lo = jnp.where(live, ia.cluster_lo[safe], 0)
        hi = jnp.where(live, ia.cluster_hi[safe], 0)
        base = ia.tri_base[safe]
        cnt = ia.tri_count[safe]
        start = ia.mesh_tri_start[safe]

        def conv(exg):
            if exg is None:
                return None
            inr = (exg >= base) & (exg < base + cnt)
            return jnp.where(inr, exg - base + start, -1)

        ex = [conv(e) for e in excludes]
        t2, ltri2, u2, v2, occ2 = intersect_clusters(
            ia.clusters, o_l, d_l, tmin, t_best,
            exclude0=ex[0], exclude1=ex[1], exclude2=ex[2],
            any_hit=any_hit, crange=(lo, hi), raw=True,
        )
        found = live & (ltri2 >= 0)
        g2 = base + (ltri2 - start)
        if any_hit:
            return t_best, gtri, u, v, occ | (live & occ2)
        better = found & (t2 < t_best)
        return (
            jnp.where(better, t2, t_best),
            jnp.where(better, g2, gtri),
            jnp.where(better, u2, u),
            jnp.where(better, v2, v),
            occ,
        )

    def round_cond(carry):
        return jnp.any(carry[-1])

    def round_body(carry):
        thresh_e, thresh_id, t_best, gtri, u, v, occ, live = carry
        entries, ids = select_insts(t_best, thresh_e, thresh_id, SELECT_I)
        for s in range(SELECT_I):
            useful = live & jnp.isfinite(entries[:, s]) & (entries[:, s] <= t_best)
            if any_hit:
                useful = useful & ~occ
            iid = jnp.where(useful, ids[:, s], -1)
            t_best, gtri, u, v, occ = test_instance(iid, t_best, gtri, u, v, occ)
        last = entries[:, SELECT_I - 1]
        last_id = ids[:, SELECT_I - 1]
        live = live & jnp.isfinite(last) & (last < t_best)
        if any_hit:
            live = live & ~occ
        return (
            jnp.where(live, last, thresh_e),
            jnp.where(live, last_id, thresh_id),
            t_best, gtri, u, v, occ, live,
        )

    carry = (
        jnp.full((n,), -jnp.inf),
        jnp.full((n,), -1, jnp.int32),
        t_best0,
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
        jnp.zeros((n,), bool),
        jnp.ones((n,), bool),
    )
    _, _, t_best, gtri, u, v, occ, _ = jax.lax.while_loop(
        round_cond, round_body, carry
    )
    if any_hit:
        return occ
    from .trace import Hit

    return Hit(t=t_best, tri_id=gtri, bary=jnp.stack([u, v], -1), valid=gtri >= 0)
