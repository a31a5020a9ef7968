"""Sharded all-vs-all / query-vs-DB distance.

The reference computes distances in a serial double loop of two-pointer
merges (/root/reference/cli/src/main.rs:315-334, lib/src/distance.rs:66-126).
Here each (query, ref) pair's integer statistics (common, i, j) are
computed on-device and the f64 distance formula is applied on host for
exact JSON parity.

Layout (inherited from an accelerator where per-pair gathers and
searchsorted were slow; not yet re-measured on the H100): pairs are
laid out as LANES of a (2K, pairs) tile whose columns are
concat(query_hashes, reversed(ref_hashes)) — an ascending-then-descending
(bitonic) sequence, since each side is already sorted. An 11-stage bitonic
merge network (static-stride compare-exchanges, log2(2K) stages instead of
a full sort's ~log^2) makes equal hashes adjacent; common = count of
adjacent equal non-sentinel lanes per column. The i/j pointer end-state is
closed-form (core/distance.py) and computed with dense masked reductions.
The reference DB is sharded over the mesh axis; each device scans its ref
shard in fixed tiles inside a fori_loop.

Exactness: for sorted distinct hash arrays the pointer-merge end state is
closed-form; this computes the same integers (property-tested against the
host oracle in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _bitonic_merge_axis0(x):
    """Merge a bitonic-per-column (n, P) array into ascending columns."""
    n, p = x.shape
    s = n // 2
    while s >= 1:
        y = x.reshape(n // (2 * s), 2, s, p)
        a, b = y[:, 0], y[:, 1]
        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)
        x = jnp.stack([lo, hi], axis=1).reshape(n, p)
        s //= 2
    return x


def _tile_stats(qpad, nq, rtile, nrtile, max_hash):
    """Integer stats for all (query, ref-in-tile) pairs.

    qpad: (Q, Kp) ascending u64 with U64_MAX padding; rtile: (Rt, Kp).
    Returns (common, i, j) of shape (Q, Rt), u64.
    """
    Q, Kp = qpad.shape
    Rt = rtile.shape[0]

    # columns = pairs: top half ascending queries, bottom half reversed refs
    qcols = jnp.broadcast_to(qpad.T[:, :, None], (Kp, Q, Rt))
    rcols = jnp.broadcast_to(rtile.T[::-1][:, None, :], (Kp, Q, Rt))
    merged = jnp.concatenate([qcols, rcols], axis=0).reshape(2 * Kp, Q * Rt)
    merged = _bitonic_merge_axis0(merged)

    eq = (merged[1:] == merged[:-1]) & (merged[1:] != U64_MAX)
    common = jnp.sum(eq.astype(jnp.uint32), axis=0).reshape(Q, Rt)

    # closed-form pointer end-state (core/distance.py):
    #   m = min(max(q), max(r)); i = #{q <= m}; j = #{r <= m}
    valid_q = qpad != U64_MAX
    valid_r = rtile != U64_MAX
    qmax = jnp.max(jnp.where(valid_q, qpad, 0), axis=1)        # (Q,)
    rmax = jnp.max(jnp.where(valid_r, rtile, 0), axis=1)       # (Rt,)
    both = (nq > 0)[:, None] & (nrtile > 0)[None, :]
    m = jnp.minimum(qmax[:, None], rmax[None, :])               # (Q, Rt)
    i = jnp.sum((qpad[:, None, :] <= m[:, :, None]) & valid_q[:, None, :],
                axis=2)
    j = jnp.sum((rtile[None, :, :] <= m[:, :, None]) & valid_r[None, :, :],
                axis=2)
    i = jnp.where(both, i, 0)
    j = jnp.where(both, j, 0)

    # scaled tail (distance.rs:99-115): advance past hashes < max_hash
    use_tail = max_hash > 0
    tail_i = jnp.sum((qpad < max_hash) & valid_q, axis=1)       # (Q,)
    tail_j = jnp.sum((rtile < max_hash) & valid_r, axis=1)      # (Rt,)
    i = jnp.where(use_tail, jnp.maximum(i, tail_i[:, None]), i)
    j = jnp.where(use_tail, jnp.maximum(j, tail_j[None, :]), j)
    return (common.astype(jnp.uint64), i.astype(jnp.uint64),
            j.astype(jnp.uint64))


@partial(jax.jit, static_argnames=("tile",))
def _pairs_stats_tiled(qpad, nq, rpad, nr, max_hash, *, tile: int):
    """(common, i, j) of shape (Q, R): fori over ref tiles of `tile`."""
    Q, Kp = qpad.shape
    R = rpad.shape[0]
    if R == 0 or Q == 0:
        z = jnp.zeros((Q, R), dtype=jnp.uint64)
        return z, z, z
    ntiles = (R + tile - 1) // tile
    pad_r = ntiles * tile - R
    if pad_r:
        rpad = jnp.concatenate(
            [rpad, jnp.full((pad_r, Kp), U64_MAX, dtype=jnp.uint64)])
        nr = jnp.concatenate([nr, jnp.zeros(pad_r, dtype=nr.dtype)])

    def body(t, outs):
        oc, oi, oj = outs
        r0 = t * jnp.int32(tile)
        rt = jax.lax.dynamic_slice(rpad, (r0, jnp.int32(0)), (tile, Kp))
        nrt = jax.lax.dynamic_slice(nr, (r0,), (tile,))
        c, i, j = _tile_stats(qpad, nq, rt, nrt, max_hash)
        oc = jax.lax.dynamic_update_slice(oc, c, (jnp.int32(0), r0))
        oi = jax.lax.dynamic_update_slice(oi, i, (jnp.int32(0), r0))
        oj = jax.lax.dynamic_update_slice(oj, j, (jnp.int32(0), r0))
        return oc, oi, oj

    # derive the zero init from the data so it carries the same sharding
    # varying-axes as the body outputs under shard_map
    z = (jnp.zeros((Q, ntiles * tile), dtype=jnp.uint64)
         + (rpad[0, 0] & jnp.uint64(0)))
    oc, oi, oj = jax.lax.fori_loop(jnp.int32(0), jnp.int32(ntiles), body,
                                   (z, z, z))
    return oc[:, :R], oi[:, :R], oj[:, :R]


def _pick_tile(q: int, kp: int) -> int:
    """Ref-tile width: keep the merge tile around <=16M lanes."""
    budget = max(1, (1 << 23) // max(1, 2 * kp * q))
    t = 1
    while t * 2 <= budget:
        t *= 2
    return t


@partial(jax.jit, static_argnames=("mesh", "axis", "tile"))
def _sharded_pairs_stats(qpad, nq, rpad, nr, max_hash, *, mesh, axis,
                         tile: int):
    """refs sharded over the mesh axis: each device scans its local shard."""

    def wrapped(q, nql, r, nrl, mh):
        c, i, j = _pairs_stats_tiled(q, nql, r[0], nrl[0], mh, tile=tile)
        return c[None], i[None], j[None]

    spec = P(axis)
    out3 = P(axis, None, None)
    return shard_map(
        wrapped, mesh=mesh,
        in_specs=(P(), P(), spec, spec, P()),
        out_specs=(out3, out3, out3),
    )(qpad, nq, rpad, nr, max_hash)


def pad_hashes(sketch_hashes: List[np.ndarray],
               k_pad: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length sorted hash arrays into (N, K) with U64_MAX
    padding (power-of-two K for the merge network); returns
    (padded, lengths)."""
    n = len(sketch_hashes)
    k_pad = k_pad or max((len(h) for h in sketch_hashes), default=1)
    kp = 1
    while kp < max(k_pad, 1):
        kp *= 2
    out = np.full((n, kp), U64_MAX, dtype=np.uint64)
    lens = np.zeros(n, dtype=np.uint32)
    for i, h in enumerate(sketch_hashes):
        out[i, : len(h)] = h
        lens[i] = len(h)
    return out, lens


def all_vs_all_arrays(query_hashes: List[np.ndarray],
                      ref_hashes: List[np.ndarray],
                      scale: float = 0.0,
                      mesh: Optional[Mesh] = None,
                      axis: Optional[str] = None):
    """Integer distance stats for all (query, ref) pairs.

    Returns (common, i, j) uint64 arrays of shape (Q, R). Callers apply the
    f64 containment/jaccard/mash formula on host (core/distance.py).

    Precondition: u64::MAX is reserved as the pad sentinel. A genuine hash
    equal to u64::MAX (probability ~n/2^64 per sketch) would be mistaken
    for padding, so such inputs are rejected here; route them through the
    exact serial engine (core/distance.py) instead — the CLI does this
    automatically via ``_uniform_dist_params``.
    """
    from finch_tpu.core.distance import scale_recip_max_hash

    for h in (*query_hashes, *ref_hashes):
        if len(h) and np.uint64(h[-1]) == U64_MAX:
            raise ValueError(
                "sketch contains hash u64::MAX, which collides with the "
                "device pad sentinel; use the serial distance engine")

    if mesh is not None and axis is None:
        axis = mesh.axis_names[0]
    kq = max((len(h) for h in query_hashes), default=1)
    kr = max((len(h) for h in ref_hashes), default=1)
    kpad = max(kq, kr, 1)
    q, nq = pad_hashes(query_hashes, kpad)
    r, nr = pad_hashes(ref_hashes, kpad)
    max_hash = scale_recip_max_hash(scale) if scale > 0.0 else 0

    if mesh is None:
        tile = _pick_tile(q.shape[0], q.shape[1])
        common, i, j = _pairs_stats_tiled(
            jnp.asarray(q), jnp.asarray(nq), jnp.asarray(r),
            jnp.asarray(nr), jnp.uint64(max_hash), tile=tile)
        return np.asarray(common), np.asarray(i), np.asarray(j)

    # shard refs over the mesh: pad R to a multiple of mesh size
    n_dev = mesh.devices.size
    R = r.shape[0]
    pad_r = (-R) % n_dev
    if pad_r:
        r = np.concatenate(
            [r, np.full((pad_r, r.shape[1]), U64_MAX, dtype=np.uint64)])
        nr = np.concatenate([nr, np.zeros(pad_r, dtype=nr.dtype)])
    per = r.shape[0] // n_dev
    tile = _pick_tile(q.shape[0], q.shape[1])
    tile = min(tile, per) if per else tile
    rsh = NamedSharding(mesh, P(axis))
    c, i, j = _sharded_pairs_stats(
        jnp.asarray(q), jnp.asarray(nq),
        jax.device_put(r.reshape(n_dev, per, r.shape[1]), rsh),
        jax.device_put(nr.reshape(n_dev, per), rsh),
        jnp.uint64(max_hash), mesh=mesh, axis=axis, tile=max(1, tile))
    # out per shard: (n_dev, Q, per) -> (Q, R)
    c = np.asarray(c).transpose(1, 0, 2).reshape(q.shape[0], -1)[:, :R]
    i = np.asarray(i).transpose(1, 0, 2).reshape(q.shape[0], -1)[:, :R]
    j = np.asarray(j).transpose(1, 0, 2).reshape(q.shape[0], -1)[:, :R]
    return c, i, j
