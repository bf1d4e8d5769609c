"""BVH build (host) + stackless traversal (device).

A software replacement for LuisaCompute's rtx::Accel hardware BVH
(ref mesh.rs:288-333, scene.rs:42-110), written as array code:

- HOST BUILD: binned-SAH BVH2 (numpy; a C++ builder drops in via
  native/ for big scenes) over world-space triangles, flattened to arrays
  in DFS order with SKIP LINKS — each node knows where to jump on a miss,
  so traversal needs no per-lane stack at all.
- DEVICE TRAVERSAL: one `lax.while_loop`; every live lane holds a node
  cursor. Inner nodes: one AABB slab test -> cursor = hit ? node+1 : skip.
  Leaves: test up to LEAF_SIZE triangles (triangles are reordered so each
  leaf is a contiguous range). All state is [N] arrays — no divergence
  penalty beyond the mask, no stacks in scarce memory.

This is the "compacted-leaf BVH evaluated with masked gathers" design from
SURVEY.md §7.3's plan, upgraded with skip links.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import RAY_TMAX

LEAF_SIZE = 4
SAH_BINS = 16


class BvhArrays(NamedTuple):
    """Flattened BVH in DFS order with skip links (device pytree)."""

    bmin: jnp.ndarray  # [M, 3]
    bmax: jnp.ndarray  # [M, 3]
    start: jnp.ndarray  # [M] leaf: first triangle (in REORDERED order); inner: 0
    count: jnp.ndarray  # [M] leaf: tri count; inner: 0
    skip: jnp.ndarray  # [M] node index to jump to on miss/after-leaf (M = end)
    order: jnp.ndarray  # [T] reordered tri -> original tri id


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BvhArrays:
    """Binned-SAH build: C++ (native/bvh_builder.cpp) with numpy fallback."""
    from ..native import build_bvh_native

    nat = build_bvh_native(v0, e1, e2)
    if nat is not None:
        return BvhArrays(
            bmin=jnp.asarray(nat["bmin"]),
            bmax=jnp.asarray(nat["bmax"]),
            start=jnp.asarray(nat["start"]),
            count=jnp.asarray(nat["count"]),
            skip=jnp.asarray(nat["skip"]),
            order=jnp.asarray(nat["order"]),
        )
    return _build_bvh_py(v0, e1, e2)


def _build_bvh_py(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BvhArrays:
    """Pure-numpy binned-SAH build (fallback when g++ is unavailable)."""
    T = len(v0)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    centroid = 0.5 * (lo + hi)

    # node soup built depth-first so skip links are trivial
    bmin, bmax, start, count, skip = [], [], [], [], []
    order = np.arange(T)

    def push(node_lo, node_hi, s, c):
        bmin.append(node_lo)
        bmax.append(node_hi)
        start.append(s)
        count.append(c)
        skip.append(-1)
        return len(bmin) - 1

    def partition(ids):
        """Returns (axis split) -> (left ids, right ids) or None for leaf."""
        if len(ids) <= LEAF_SIZE:
            return None
        clo = centroid[ids]
        cmin, cmax = clo.min(0), clo.max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            return None
        # binned SAH
        rel = (clo[:, axis] - cmin[axis]) / ext[axis]
        bins = np.minimum((rel * SAH_BINS).astype(np.int32), SAH_BINS - 1)
        costs = np.full(SAH_BINS - 1, np.inf)
        lo_i, hi_i = lo[ids], hi[ids]
        for b in range(SAH_BINS - 1):
            left = bins <= b
            nl = left.sum()
            nr = len(ids) - nl
            if nl == 0 or nr == 0:
                continue
            la = _surface(lo_i[left], hi_i[left])
            ra = _surface(lo_i[~left], hi_i[~left])
            costs[b] = la * nl + ra * nr
        if not np.isfinite(costs).any():
            # fall back to median split
            med = np.argsort(clo[:, axis])
            h = len(ids) // 2
            return ids[med[:h]], ids[med[h:]]
        b = int(np.argmin(costs))
        left = bins <= b
        return ids[left], ids[~left]

    new_order = []
    # DFS with explicit stack of (ids, parent_done_callback)
    stack = [(order, None)]
    # we record per-node the subtree-end to assign skip links afterwards
    subtree_end = {}

    def emit(ids):
        node = push(lo[ids].min(0), hi[ids].max(0), 0, 0)
        split = partition(ids)
        if split is None:
            start[node] = len(new_order)
            count[node] = len(ids)
            new_order.extend(ids.tolist())
        else:
            l, r = split
            emit(l)
            emit(r)
        subtree_end[node] = len(bmin)
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * T + 1000))
    try:
        emit(order)
    finally:
        sys.setrecursionlimit(old_limit)

    M = len(bmin)
    skip_arr = np.array([subtree_end[i] for i in range(M)], np.int32)
    return BvhArrays(
        bmin=jnp.asarray(np.asarray(bmin, np.float32)),
        bmax=jnp.asarray(np.asarray(bmax, np.float32)),
        start=jnp.asarray(np.asarray(start, np.int32)),
        count=jnp.asarray(np.asarray(count, np.int32)),
        skip=jnp.asarray(skip_arr),
        order=jnp.asarray(np.asarray(new_order, np.int32)),
    )


def _surface(lo, hi):
    if len(lo) == 0:
        return 0.0
    d = hi.max(0) - lo.min(0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


# ---------------------------------------------------------------- traversal
class _TraceState(NamedTuple):
    node: jnp.ndarray  # [N] cursor
    t: jnp.ndarray  # [N] best hit distance
    tri: jnp.ndarray  # [N] best tri id (original numbering), -1 = miss
    u: jnp.ndarray
    v: jnp.ndarray
    occluded: jnp.ndarray  # [N] (any-hit mode)


def _slab_test(bmin, bmax, o, inv_d, tmin, tmax):
    """Ray-AABB slab test; bmin/bmax [N, 3]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tn, -1), tmin)
    far = jnp.minimum(jnp.min(tf, -1), tmax)
    return near <= far


def _leaf_test(bvh, sv0, se1, se2, state, o, d, tmin, ex0, ex1, any_hit):
    """Test up to LEAF_SIZE triangles of the cursor's leaf (masked)."""
    node = state.node
    s = bvh.start[node]
    c = bvh.count[node]
    t_best, tri_best, u_best, v_best = state.t, state.tri, state.u, state.v
    occ = state.occluded
    for k in range(LEAF_SIZE):
        live = k < c
        idx = jnp.minimum(s + k, sv0.shape[0] - 1)
        tri_orig = bvh.order[idx]
        a = sv0[idx]
        b1 = se1[idx]
        b2 = se2[idx]
        # Möller-Trumbore, per-lane
        pvec = jnp.cross(d, b2)
        det = jnp.sum(pvec * b1, -1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - a
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, b1)
        v = jnp.sum(qvec * d, -1) * inv_det
        t = jnp.sum(qvec * b2, -1) * inv_det
        hit = (
            live
            & (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin)
            & (t < t_best)
        )
        if ex0 is not None:
            hit = hit & (tri_orig != ex0)
        if ex1 is not None:
            hit = hit & (tri_orig != ex1)
        if any_hit:
            occ = occ | hit
        else:
            t_best = jnp.where(hit, t, t_best)
            tri_best = jnp.where(hit, tri_orig, tri_best)
            u_best = jnp.where(hit, u, u_best)
            v_best = jnp.where(hit, v, v_best)
    return state._replace(t=t_best, tri=tri_best, u=u_best, v=v_best, occluded=occ)


def traverse(bvh: BvhArrays, sv0, se1, se2, o, d, tmin, tmax,
             exclude0=None, exclude1=None, any_hit=False):
    """Stackless skip-link traversal for a ray batch.

    sv0/se1/se2 are the triangle arrays in BVH-REORDERED order (precompute
    once at scene build: v0[bvh.order] etc.).
    Returns a Hit-like tuple (t, tri_id, bary, valid) or occluded mask.
    """
    n = o.shape[0]
    num_nodes = bvh.bmin.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)

    state = _TraceState(
        node=jnp.zeros((n,), jnp.int32),
        t=jnp.minimum(jnp.full((n,), RAY_TMAX), tmax),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
        occluded=jnp.zeros((n,), bool),
    )

    def cond(st):
        live = st.node < num_nodes
        if any_hit:
            live = live & ~st.occluded
        return jnp.any(live)

    def _advance_to_leaf(st):
        """Inner while-while phase: cheap node stepping (one slab test per
        step) until every live lane is parked on a hit leaf or finished."""

        def on_inner(st):
            node = jnp.minimum(st.node, num_nodes - 1)
            done = st.node >= num_nodes
            cnt = bvh.count[node]
            hit_box = _slab_test(bvh.bmin[node], bvh.bmax[node], o, inv_d, tmin, st.t)
            parked = (~done) & hit_box & (cnt > 0)
            return jnp.any(~done & ~parked)

        def step(st):
            node = jnp.minimum(st.node, num_nodes - 1)
            done = st.node >= num_nodes
            cnt = bvh.count[node]
            hit_box = _slab_test(bvh.bmin[node], bvh.bmax[node], o, inv_d, tmin, st.t)
            is_leaf = cnt > 0
            parked = hit_box & is_leaf
            descend = hit_box & ~is_leaf
            nxt = jnp.where(descend, node + 1, bvh.skip[node])
            nxt = jnp.where(done | parked, st.node, nxt)
            return st._replace(node=nxt)

        return jax.lax.while_loop(on_inner, step, st)

    def body(st):
        st = _advance_to_leaf(st)
        # every live lane now sits on a hit leaf: batch the triangle tests
        node = jnp.minimum(st.node, num_nodes - 1)
        done = st.node >= num_nodes
        on_leaf = ~done & (bvh.count[node] > 0)
        st_leaf = _leaf_test(
            bvh, sv0, se1, se2, st._replace(node=node), o, d, tmin,
            exclude0, exclude1, any_hit,
        )
        st = _TraceState(
            node=st.node,
            t=jnp.where(on_leaf, st_leaf.t, st.t),
            tri=jnp.where(on_leaf, st_leaf.tri, st.tri),
            u=jnp.where(on_leaf, st_leaf.u, st.u),
            v=jnp.where(on_leaf, st_leaf.v, st.v),
            occluded=jnp.where(on_leaf, st_leaf.occluded, st.occluded),
        )
        nxt = jnp.where(done, st.node, bvh.skip[node])
        if any_hit:
            nxt = jnp.where(st.occluded, num_nodes, nxt)
        return st._replace(node=nxt)

    st = jax.lax.while_loop(cond, body, state)
    if any_hit:
        return st.occluded
    from .trace import Hit

    return Hit(
        t=st.t,
        tri_id=st.tri,
        bary=jnp.stack([st.u, st.v], -1),
        valid=st.tri >= 0,
    )
