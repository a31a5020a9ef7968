"""All-vs-all sketch intersection as run-indicator matmuls.

Restructuring of `finch dist --pairwise` at DB scale
(reference: a serial per-pair two-pointer merge over every (query, ref)
combination, /root/reference/lib/src/distance.rs:66-126 driven by
main.rs:315-334). Instead of N^2 pairwise merges, observe that the whole
common-count matrix is a Gram matrix:

    common = M @ M.T      where M[n, d] = 1 iff distinct hash d ∈ sketch n

and M's rows only interact through hashes shared by >= 2 sketches. So:

  1. ONE global sort of all (hash, sketch_id) pairs groups equal hashes
     into runs (the accelerator-friendly replacement for N^2 pointer walks).
  2. Runs of length 1 (hashes unique to one sketch) contribute nothing
     off-diagonal and are dropped; the diagonal is just the sketch sizes.
  3. The surviving (run, sketch) incidences form E, a (runs x N) 0/1
     block matrix built run-block by run-block; common += E_blk.T @ E_blk
     on the tensor cores (bf16 inputs are exact 0/1 and the f32
     accumulation is exact for counts < 2^24; the int8 form accumulates
     in int32). No float32 operand enters a matmul, so TF32 never
     applies.

The i/j pointer-end counts decompose per pair as #{h <= m} with
m = min(max_q, max_r) (see core/distance.py's closed form), computed by
batched searchsorted of the sketch-maxima vector into each row — O(N^2)
output, O(N K + N^2) work, no pairwise merges.

Cost scales with actual sharing (sum of run sizes >= 2), not with
N^2 K: disjoint DBs cost one sort; heavily-overlapping DBs turn into
dense matrix-unit work. Exactness is property-tested against
core/distance.py (tests/test_mxu_dist.py).

Sharding: run-blocks are independent, so the E-matmul loop data-parallels
over a mesh axis with a single psum at the end (`sharded_common`).
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from finch_tpu.models.params import U64_MAX

__all__ = ["all_pairs_stats", "all_pairs_common", "pack_db"]

# E-block Gram matmul precision: bf16 inputs + f32 accumulation by
# default, exact while per-pair counts stay below 2^24 (guarded by
# _check_f32_gram_bound). On the H100 it ran the 10k x 10k x 1000
# clustered Gram 2.4x faster than int8 inputs + int32 accumulation
# (PERF.md); both give identical matrices (chip_smoke.py phase 4).
# FINCH_TPU_GRAM_INT8=1 compiles the int8 form (exact to 2^31).
GRAM_INT8 = os.environ.get("FINCH_TPU_GRAM_INT8", "0") == "1"


def _gram_dot(E, RB: int, n_sketches: int, common, int8: bool):
    """One page's Gram term: common += E[:RB-1, :n]^T @ E[:RB-1, :n]."""
    if int8:
        Eb = E[: RB - 1, :n_sketches].astype(jnp.int8)
        return common + jnp.dot(Eb.T, Eb,
                                preferred_element_type=jnp.int32)
    Eb = E[: RB - 1, :n_sketches].astype(jnp.bfloat16)
    return common + jnp.dot(Eb.T, Eb, preferred_element_type=jnp.float32)


def _gram_zero(n_sketches: int, int8: bool):
    return jnp.zeros((n_sketches, n_sketches),
                     jnp.int32 if int8 else jnp.float32)


def pack_db(sketch_hashes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length sorted hash arrays into (N, K) u64 with
    U64_MAX padding + (N,) lengths."""
    n = len(sketch_hashes)
    k = max((len(h) for h in sketch_hashes), default=1)
    out = np.full((n, max(k, 1)), U64_MAX, dtype=np.uint64)
    lens = np.zeros(n, dtype=np.int32)
    for i, h in enumerate(sketch_hashes):
        out[i, : len(h)] = h
        lens[i] = len(h)
    return out, lens


# ---------------------------------------------------------------------------
# phase 1: global sort -> shared-hash incidences (run_id, sketch_id)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cap",))
def _shared_incidences(hashes: jnp.ndarray, sid: jnp.ndarray, cap: int):
    """Sort (hash, sid); keep elements whose hash occurs >= 2 times
    (pads at U64_MAX never duplicate real hashes and pad-pad runs are
    masked); compact them to the front of fixed-size (cap,) arrays.

    Returns (run_id i32[cap], sid i32[cap], n_shared i32, n_runs i32).
    run_ids are dense (0..n_runs-1) over the shared elements only.
    """
    hs, ss = lax.sort((hashes, sid), num_keys=1)
    real = hs != jnp.uint64(U64_MAX)
    prev_eq = jnp.concatenate(
        [jnp.zeros(1, jnp.bool_), hs[1:] == hs[:-1]])
    next_eq = jnp.concatenate(
        [hs[1:] == hs[:-1], jnp.zeros(1, jnp.bool_)])
    multi = (prev_eq | next_eq) & real
    # dense run ids over shared elements: new run where multi & !prev_eq
    new_run = multi & ~prev_eq
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_shared = jnp.sum(multi.astype(jnp.int32))
    n_runs = jnp.sum(new_run.astype(jnp.int32))
    # compact (stable sort by !multi keeps hash order within the kept set)
    key = (~multi).astype(jnp.int32)
    _, rid_c, sid_c = lax.sort((key, rid, ss), num_keys=1)
    return rid_c[:cap], sid_c[:cap], n_shared, n_runs


# ---------------------------------------------------------------------------
# phase 2: E-block Gram accumulation on the MXU
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_sketches", "page", "int8"))
def _gram_accumulate(rid: jnp.ndarray, sid: jnp.ndarray, n_shared,
                     n_sketches: int, page: int, int8: bool = False):
    """common (N, N) f32 = sum over element pages of E_page^T @ E_page.

    Pages are cut at run boundaries (a page never splits a run, so every
    run's full outer product lands in exactly one Gram term). Row space =
    dense within-page run index; since every run has >= 2 elements, a
    page of P elements holds <= P/2 runs. `page` must exceed the longest
    possible run (= n_sketches: a run holds each sketch at most once).

    Scatter conflicts cannot occur (distinct hashes per sketch), and the
    overflow row/column absorb masked lanes so no index is ever clamped.
    """
    cap = rid.shape[0]
    BIG = jnp.int32(2 ** 31 - 1)
    valid = jnp.arange(cap, dtype=jnp.int32) < n_shared
    # pad by one page of BIG so a slice starting at any e0 < cap stays
    # in-bounds (dynamic_slice would otherwise clamp the start backwards
    # and re-cover already-processed runs)
    rid = jnp.concatenate([jnp.where(valid, rid, BIG),
                           jnp.full(page + 1, BIG, jnp.int32)])
    sid = jnp.concatenate([sid, jnp.zeros(page + 1, jnp.int32)])
    RB = page // 2 + 2

    def cond(c):
        _, e0 = c
        return e0 < n_shared

    def body(c):
        common, e0 = c
        sl_r = lax.dynamic_slice(rid, (e0,), (page,))
        sl_s = lax.dynamic_slice(sid, (e0,), (page,))
        last = sl_r[page - 1]
        nxt = lax.dynamic_slice(rid, (e0 + page,), (1,))[0]
        # exclude the run that straddles the page end (it moves whole to
        # the next page); pads (BIG) are excluded the same way
        ends_clean = (nxt != last) & (last != BIG)
        n_valid = jnp.where(
            ends_clean, jnp.int32(page),
            jnp.searchsorted(sl_r, last).astype(jnp.int32))
        newr = jnp.concatenate(
            [jnp.ones(1, jnp.bool_), sl_r[1:] != sl_r[:-1]])
        rows = jnp.cumsum(newr.astype(jnp.int32)) - 1
        ok = jnp.arange(page, dtype=jnp.int32) < n_valid
        rows = jnp.where(ok, jnp.minimum(rows, RB - 1), RB - 1)
        cols = jnp.where(ok, sl_s, jnp.int32(n_sketches))
        E = jnp.zeros((RB, n_sketches + 1), jnp.float32)
        E = E.at[rows, cols].add(1.0)
        common = _gram_dot(E, RB, n_sketches, common, int8)
        return common, e0 + jnp.maximum(n_valid, 1)

    common, _ = lax.while_loop(cond, body,
                               (_gram_zero(n_sketches, int8), jnp.int32(0)))
    return common


def candidate_mask_consts(k: float, max_distance: float):
    """(j_min_lo f32, eps f32) for the conservative candidate test
    `common >= total * j_min_lo - eps`. mash <= d is monotone in
    jaccard with boundary j_min = e^{-kd} / (2 - e^{-kd}); the margin
    guarantees no exact survivor is dropped in f32 (false positives are
    removed by the exact f64 recheck). ONE definition shared by the host
    prefilter, the device survivors kernel, and the equality tests — the
    two paths' supersets must stay identical."""
    import math

    e = math.exp(-k * max_distance)
    j_min = e / (2.0 - e)
    return np.float32(j_min * (1.0 - 1e-4)), np.float32(1e-3)


def _sketch_maxima(hashes_padded: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
    """Per-sketch largest hash (0 for empty sketches)."""
    return np.array(
        [hashes_padded[i, lengths[i] - 1] if lengths[i] else np.uint64(0)
         for i in range(len(lengths))], dtype=np.uint64)


def _page_size(run_block: int, n: int, cap: int) -> int:
    """Gram page: smallest power of two > max(run_block, n), clamped to
    the element count (a page must never split a run; the longest run
    holds each sketch once)."""
    page = 2
    while page < max(run_block, n + 1):
        page *= 2
    return min(page, max(int(cap), 2))


def _check_f32_gram_bound(k: int) -> None:
    """The f32 Gram accumulation is exact only while per-pair common counts
    stay below 2^24; a pair's common count is bounded by the padded sketch
    length, so enforce the precondition instead of assuming it. (The int8
    path accumulates in int32: exact to 2^31.)"""
    if k >= (1 << 31 if GRAM_INT8 else 1 << 24):
        raise ValueError(
            "Gram distance engine: sketch length exceeds the exact "
            "accumulation bound; use the tile engine "
            "(parallel.sharded_dist) for sketches this large")


def _common_device(hashes_padded: np.ndarray, run_block: int):
    """Dispatch the Gram computation; returns the (N, N) DEVICE array
    (u16 when the padded sketch length allows, else f32) without
    synchronizing — callers overlap the host fetch with later work."""
    n, k = hashes_padded.shape
    _check_f32_gram_bound(k)
    flat_h = jnp.asarray(hashes_padded.reshape(-1))
    flat_s = jnp.tile(jnp.arange(n, dtype=jnp.int32)[:, None],
                      (1, k)).reshape(-1)
    cap = flat_h.shape[0]
    rid, sid, n_shared, _ = _shared_incidences(flat_h, flat_s, cap)
    page = _page_size(run_block, n, cap)
    common = _gram_accumulate(rid, sid, n_shared, n, page, int8=GRAM_INT8)
    if k < (1 << 16):
        # counts are bounded by the padded sketch length, so fetch the
        # (N, N) matrix as u16 — exact, and half the host transfer of
        # the int32 form (at 10k sketches that is 400 MB)
        common = jax.jit(lambda c: c.astype(jnp.uint16))(common)
    return common


def all_pairs_common(hashes_padded: np.ndarray, lengths: np.ndarray,
                     run_block: int = 2048) -> np.ndarray:
    """Exact |q ∩ r| for all sketch pairs. (N, N) int64; the diagonal is
    the sketch sizes.

    Device memory is bounded by the one global sort (~16 bytes per
    element plus payload; 10k x 1k = 10M elements ~ 160 MB). DBs beyond
    one chip's memory shard over a mesh via `sharded_common`.
    """
    common = np.asarray(
        _common_device(hashes_padded, run_block)).astype(np.int64)
    np.fill_diagonal(common, np.asarray(lengths, dtype=np.int64))
    return common


# ---------------------------------------------------------------------------
# phase 3: i/j pointer-end counts
# ---------------------------------------------------------------------------

def _below_counts(hashes_padded: np.ndarray, lengths: np.ndarray,
                  thresholds: np.ndarray, side: str = "right") -> np.ndarray:
    """counts[n, t] = number of hashes in sketch n that are <=
    thresholds[t] (side 'right') or strictly below (side 'left').

    One searchsorted of ALL elements into the sorted threshold vector +
    a per-row bin histogram + cumsum - O(NK log N + N^2), no per-row
    Python calls (a 10k x 10k below-matrix builds in ~1s instead of the
    22s a per-row searchsorted loop took). Pads (U64_MAX) land in the
    overflow bin of every threshold and contribute nothing (genuine
    u64::MAX hashes are rejected by callers upstream).
    """
    n, k = hashes_padded.shape
    m = len(thresholds)
    order = np.argsort(thresholds, kind="stable")
    sm = thresholds[order]
    flat = hashes_padded.reshape(-1)
    # bin(h) = number of sorted thresholds the element does NOT count
    # toward; it counts toward threshold ranks >= bin(h)
    ss_side = "left" if side == "right" else "right"
    bins = np.searchsorted(sm, flat, ss_side).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    hist = np.bincount(rows * (m + 1) + bins,
                       minlength=n * (m + 1)).reshape(n, m + 1)
    # counts fit i32 (<= k per row); halving the element width halves the
    # traffic of the cumsum and the column un-permute gather
    csum = np.cumsum(hist[:, :m].astype(np.int32), axis=1)
    inv = np.empty(m, dtype=np.int64)
    inv[order] = np.arange(m)
    return csum.take(inv, axis=1)


def all_pairs_stats(hashes_padded: np.ndarray, lengths: np.ndarray,
                    scale: float = 0.0, run_block: int = 2048,
                    device_ij: bool = False):
    """(common, i, j) int64 (N, N) matrices with raw_distance semantics:
    i[q, r] = #{q's hashes <= min(max_q, max_r)} plus the scaled-tail
    advance past hashes < max_hash (distance.rs:99-115); j = transpose
    role. Self-pairs are included (callers skip them like main.rs:322)."""
    from finch_tpu.core.distance import scale_recip_max_hash

    n = hashes_padded.shape[0]
    lengths = np.asarray(lengths, dtype=np.int64)
    # dispatch the Gram first and fetch it LAST: the (N, N) transfer then
    # overlaps the whole below-counts phase (device queue for device_ij,
    # host numpy otherwise) instead of serializing in front of it
    common_dev = _common_device(hashes_padded, run_block)

    maxima = _sketch_maxima(hashes_padded, lengths)
    # below[q, r] = #{q <= max_r}
    if device_ij:
        # dispatch the below sort, THEN fetch common: the transfer rides
        # alongside the below kernels still executing on device
        below_dev, finalize = _below_counts_device_dispatch(
            hashes_padded, maxima)
        common = np.asarray(common_dev).astype(np.int64)
        below = finalize(np.asarray(below_dev))
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(np.asarray, common_dev)
            below = _below_counts(hashes_padded, lengths, maxima,
                                  side="right")
            common = fut.result().astype(np.int64)
    np.fill_diagonal(common, lengths)
    # m = min(max_q, max_r): i = #{q <= m} = min(below[q, r], len_q) with
    # the convention that when max_q <= max_r, #{q <= m} = len_q
    i_mat = np.minimum(below, lengths[:, None])
    j_mat = i_mat.T.copy()

    empty = lengths == 0
    if empty.any():
        i_mat[empty, :] = 0
        i_mat[:, empty] = 0
        j_mat[empty, :] = 0
        j_mat[:, empty] = 0

    if scale > 0.0:
        # scaled-tail rule (distance.rs:99-115): advance both pointers
        # past hashes strictly below max_hash
        max_hash = np.uint64(scale_recip_max_hash(scale))
        sb = _below_counts(
            hashes_padded, lengths, np.array([max_hash], dtype=np.uint64),
            side="left")[:, 0]
        i_mat = np.maximum(i_mat, sb[:, None])   # query side
        j_mat = np.maximum(j_mat, sb[None, :])   # ref side
    return common, i_mat, j_mat


# ---------------------------------------------------------------------------
# device-side survivor compaction: mask + compact the candidate pairs on
# chip so only ~survivors bytes cross the host link, not the (N, N) matrix
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_sketches", "page", "int8", "cap",
                                   "scaled"))
def _survivors_device(H, len32, maxima_sorted, inv_perm, sb, jmin_lo, eps,
                      n_sketches: int, page: int, int8: bool, cap: int,
                      scaled: bool):
    """Candidate (mash <= d) pairs compacted on device.

    Computes the Gram common matrix and the below-count i/j stats on
    chip, applies the conservative f32 candidate test (see
    cli._calc_distances_gram — same margin, exact f64 recheck happens on
    host), and compacts the surviving (flat_idx, c, i, j) tuples to the
    front with one keyed sort. Returns (idx u32[cap], c u16[cap],
    i u16[cap], j u16[cap], count) — values beyond count are pad."""
    n = n_sketches
    flat_h = H.reshape(-1)
    flat_s = jnp.tile(jnp.arange(n, dtype=jnp.int32)[:, None],
                      (1, H.shape[1])).reshape(-1)
    rid, sid, n_shared, _ = _shared_incidences(flat_h, flat_s,
                                               int(flat_h.shape[0]))
    common = _gram_accumulate(rid, sid, n_shared, n, page, int8=int8)
    cf = common.astype(jnp.float32)
    c_int = common.astype(jnp.uint32)  # exact: f32 accum bound is 2^24

    below = _below_counts_device_sorted(H, maxima_sorted)[:, inv_perm]
    base = jnp.minimum(below, len32[:, None])
    empty = len32 == 0
    base = jnp.where(empty[:, None] | empty[None, :], 0, base)
    if scaled:
        i_mat = jnp.maximum(base, sb[:, None])
        j_mat = jnp.maximum(base.T, sb[None, :])
    else:
        i_mat = base
        j_mat = base.T
    tf = (i_mat + j_mat).astype(jnp.float32) - cf
    keep = cf >= tf * jmin_lo - eps
    keep &= ~jnp.eye(n, dtype=bool)

    BIGK = jnp.uint32(0xFFFFFFFF)
    key = jnp.where(keep,
                    jnp.arange(n * n, dtype=jnp.uint32).reshape(n, n),
                    BIGK).reshape(-1)
    count = jnp.sum(keep.astype(jnp.int32))
    key_s, c_s, i_s, j_s = lax.sort(
        (key, c_int.reshape(-1), i_mat.astype(jnp.uint32).reshape(-1),
         j_mat.astype(jnp.uint32).reshape(-1)), num_keys=1)
    return (key_s[:cap], c_s[:cap].astype(jnp.uint16),
            i_s[:cap].astype(jnp.uint16), j_s[:cap].astype(jnp.uint16),
            count)


def all_pairs_survivors(hashes_padded: np.ndarray, lengths: np.ndarray,
                        scale: float, k: float, max_distance: float,
                        run_block: int = 2048):
    """(iq, jr, common, i, j) int64 arrays for every candidate pair whose
    mash distance can be <= max_distance (a conservative superset — the
    caller reruns the exact f64 filter), in ref-major/query-minor order.

    Device-side replacement for all_pairs_stats + host masking when only
    the survivors are needed: at 10k sketches the (N, N) stat matrices
    are hundreds of MB of host transfer while the survivors are a few.
    Returns None when the workload is out of contract (max_distance >= 1
    keeps everything; counts must fit u16; survivor overflow) — callers
    fall back to the full-matrix path."""
    n, kpad = hashes_padded.shape
    # the device pass holds several (N, N) matrices plus a 4-operand
    # N^2 sort (~60 bytes/pair live); past ~16k sketches that outgrows
    # one chip's HBM, so the full-matrix host path takes over
    if (max_distance >= 1.0 or kpad >= (1 << 16) or n < 2
            or n > (1 << 14)):
        return None
    _check_f32_gram_bound(kpad)
    lengths = np.asarray(lengths, dtype=np.int32)
    maxima = _sketch_maxima(hashes_padded, lengths)
    order = np.argsort(maxima, kind="stable")
    inv = np.empty(n, dtype=np.int32)
    inv[order] = np.arange(n, dtype=np.int32)

    scaled = scale > 0.0
    if scaled:
        from finch_tpu.core.distance import scale_recip_max_hash

        max_hash = np.uint64(scale_recip_max_hash(scale))
        sb = _below_counts(hashes_padded, lengths,
                           np.array([max_hash], dtype=np.uint64),
                           side="left")[:, 0].astype(np.int32)
    else:
        sb = np.zeros(n, dtype=np.int32)

    j_min_lo, eps = candidate_mask_consts(k, max_distance)
    page = _page_size(run_block, n, n * kpad)
    cap = min(n * n, 1 << 22)

    idx_d, c_d, i_d, j_d, count_d = _survivors_device(
        jnp.asarray(hashes_padded), jnp.asarray(lengths),
        jnp.asarray(maxima[order]), jnp.asarray(inv), jnp.asarray(sb),
        jnp.float32(j_min_lo), jnp.float32(eps),
        n_sketches=n, page=page, int8=GRAM_INT8, cap=cap, scaled=scaled)
    count = int(count_d)
    if count > cap:
        return None
    idx = np.asarray(idx_d[:count]).astype(np.int64)
    c = np.asarray(c_d[:count]).astype(np.int64)
    i_v = np.asarray(i_d[:count]).astype(np.int64)
    j_v = np.asarray(j_d[:count]).astype(np.int64)
    iq = idx // n
    jr = idx % n
    # diagonal is the sketch sizes (fill_diagonal equivalent) — excluded
    # by the mask, so c never needs the diagonal fix here
    rm = np.argsort(jr * n + iq, kind="stable")  # ref-major output order
    return iq[rm], jr[rm], c[rm], i_v[rm], j_v[rm]


# ---------------------------------------------------------------------------
# mesh-sharded Gram: element ranges (cut at run boundaries) per device
# ---------------------------------------------------------------------------

def sharded_common(hashes_padded: np.ndarray, lengths: np.ndarray,
                   mesh, axis: Optional[str] = None,
                   run_block: int = 2048) -> np.ndarray:
    """all_pairs_common over a jax Mesh: the incidence list is computed
    once (replicated — sorts are cheap relative to the Gram), each device
    Grams a contiguous element range aligned to run boundaries, and a
    single psum combines the (N, N) partials across the devices."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if axis is None:
        axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n, k = hashes_padded.shape
    _check_f32_gram_bound(k)
    flat_h = jnp.asarray(hashes_padded.reshape(-1))
    flat_s = jnp.tile(jnp.arange(n, dtype=jnp.int32)[:, None],
                      (1, k)).reshape(-1)
    cap = int(flat_h.shape[0])
    rid, sid, n_shared, _ = _shared_incidences(flat_h, flat_s, cap)
    page = _page_size(run_block, n, cap)

    def device_fn(rid, sid, n_shared):
        d = lax.axis_index(axis)
        # beyond n_shared the compacted rid values are not sorted (they
        # are singleton-run leftovers); mask them before binary search
        big = jnp.int32(2 ** 31 - 1)
        rid_m = jnp.where(jnp.arange(cap, dtype=jnp.int32) < n_shared,
                          rid, big)
        lo_nom = (d * cap // n_dev).astype(jnp.int32)
        hi_nom = ((d + 1) * cap // n_dev).astype(jnp.int32)
        # a boundary moves to the start of the run containing its nominal
        # position, applied identically on both sides -> exact partition
        lo = jnp.searchsorted(rid_m, rid_m[lo_nom]).astype(jnp.int32)
        hi = jnp.where(hi_nom >= cap, jnp.int32(cap),
                       jnp.searchsorted(
                           rid_m, rid_m[jnp.minimum(hi_nom, cap - 1)])
                       .astype(jnp.int32))
        local = _gram_range(rid_m, sid, n_shared, lo, hi, n, page,
                            int8=GRAM_INT8)
        return lax.psum(local, axis)

    fn = shard_map(device_fn, mesh=mesh,
                   in_specs=(P(), P(), P()), out_specs=P(),
                   check_vma=False)
    common = np.asarray(fn(rid, sid, n_shared), dtype=np.int64)
    np.fill_diagonal(common, np.asarray(lengths, dtype=np.int64))
    return common


@partial(jax.jit, static_argnames=("n_sketches", "page", "int8"))
def _gram_range(rid, sid, n_shared, lo, hi, n_sketches: int, page: int,
                int8: bool = False):
    """_gram_accumulate restricted to elements [lo, hi)."""
    # pin the loop-carry dtype (x64 mode promotes mixed scalar arithmetic)
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)
    n_shared = n_shared.astype(jnp.int32)
    cap = rid.shape[0]
    BIG = jnp.int32(2 ** 31 - 1)
    valid = jnp.arange(cap, dtype=jnp.int32) < n_shared
    rid = jnp.concatenate([jnp.where(valid, rid, BIG),
                           jnp.full(page + 1, BIG, jnp.int32)])
    sid = jnp.concatenate([sid, jnp.zeros(page + 1, jnp.int32)])
    RB = page // 2 + 2
    end = jnp.minimum(hi, n_shared)

    def cond(c):
        _, e0 = c
        return e0 < end

    def body(c):
        common, e0 = c
        sl_r = lax.dynamic_slice(rid, (e0,), (page,))
        sl_s = lax.dynamic_slice(sid, (e0,), (page,))
        last = sl_r[page - 1]
        nxt = lax.dynamic_slice(rid, (e0 + page,), (1,))[0]
        ends_clean = (nxt != last) & (last != BIG)
        n_valid = jnp.where(
            ends_clean, jnp.int32(page),
            jnp.searchsorted(sl_r, last).astype(jnp.int32))
        # never cross the range end (end is run-aligned by construction)
        n_valid = jnp.minimum(n_valid, end - e0)
        newr = jnp.concatenate(
            [jnp.ones(1, jnp.bool_), sl_r[1:] != sl_r[:-1]])
        rows = jnp.cumsum(newr.astype(jnp.int32)) - 1
        ok = jnp.arange(page, dtype=jnp.int32) < n_valid
        rows = jnp.where(ok, jnp.minimum(rows, RB - 1), RB - 1)
        cols = jnp.where(ok, sl_s, jnp.int32(n_sketches))
        E = jnp.zeros((RB, n_sketches + 1), jnp.float32)
        E = E.at[rows, cols].add(1.0)
        common = _gram_dot(E, RB, n_sketches, common, int8)
        return common, e0 + jnp.maximum(n_valid, 1)

    common, _ = lax.while_loop(cond, body, (_gram_zero(n_sketches, int8), lo))
    return common


# ---------------------------------------------------------------------------
# device-side below-counts (the i/j phase fully on-chip)
# ---------------------------------------------------------------------------

@jax.jit
def _below_counts_device_sorted(hashes_padded: jnp.ndarray,
                                sorted_thresholds: jnp.ndarray):
    """counts[n, t] = #{h in row n : h <= sorted_thresholds[t]} via a
    batched row merge: concatenate each row with the sorted threshold
    vector, tag-sort so row elements order before equal thresholds, and
    read each threshold's prefix row-element count. Three (N, K+M)-lane
    sorts + one cumsum — no per-row host calls, no searchsorted.

    Pads (U64_MAX) sort after every threshold (callers reject genuine
    u64::MAX upstream), so they never contribute.
    """
    n, k = hashes_padded.shape
    m = sorted_thresholds.shape[0]
    vals = jnp.concatenate(
        [hashes_padded,
         jnp.broadcast_to(sorted_thresholds[None, :], (n, m))], axis=1)
    # tag 0 = row element, 1 = threshold (equal values: row element first,
    # so prefix counts implement '<=')
    tag = jnp.concatenate(
        [jnp.zeros((n, k), jnp.int32), jnp.ones((n, m), jnp.int32)], axis=1)
    sv, st = lax.sort((vals, tag), dimension=1, num_keys=2)
    prefix = jnp.cumsum((st == 0).astype(jnp.int32), axis=1)
    # compact the m threshold entries (ascending value = ascending rank)
    # to the front, carrying their prefix counts
    _, counts = lax.sort(((st == 0).astype(jnp.int32), prefix),
                         dimension=1, num_keys=1)
    return counts[:, :m]


def _below_counts_device_dispatch(hashes_padded: np.ndarray,
                                  thresholds: np.ndarray):
    """Dispatch phase of below_counts_device: returns (device_counts,
    finalize) where finalize(np_counts) un-permutes the columns. Split so
    callers can overlap other transfers with the device execution."""
    order = np.argsort(thresholds, kind="stable")
    counts_dev = _below_counts_device_sorted(
        jnp.asarray(hashes_padded), jnp.asarray(thresholds[order]))
    inv = np.empty(len(thresholds), dtype=np.int64)
    inv[order] = np.arange(len(thresholds))

    def finalize(counts: np.ndarray) -> np.ndarray:
        return counts.take(inv, axis=1)

    return counts_dev, finalize


def below_counts_device(hashes_padded: np.ndarray, lengths: np.ndarray,
                        thresholds: np.ndarray) -> np.ndarray:
    """Device variant of _below_counts(side='right'); same contract."""
    counts_dev, finalize = _below_counts_device_dispatch(
        hashes_padded, thresholds)
    return finalize(np.asarray(counts_dev))
