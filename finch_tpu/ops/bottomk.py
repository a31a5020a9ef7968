"""Batched bottom-k sketch selection with count tracking.

Replaces the reference's serial streaming heap
(/root/reference/lib/src/sketch_schemes/mash.rs:34-63) with an
order-equivalent batched reduction. Equivalence (provable from the heap's
monotone max): the final streaming sketch is exactly the K smallest distinct
hash values with count = total stream occurrences and extra_count = total
reverse-complement occurrences. The scaled variant (scaled.rs:37-61) is
"all distinct hashes <= max_hash, topped up with the smallest above-threshold
hashes to `size` total".

Device layout (every step is plain XLA: sorts, elementwise passes and
bounded while_loops; the layout is inherited from an earlier accelerator
whose gathers, scatters and cumsums were slow, and is kept until an H100
A/B against a plain survivor sort or cumsum compaction says otherwise):

  * admission prefilter: batch hashes above the current Kth-smallest can
    never enter the final sketch, and all occurrences of surviving hashes
    pass the filter, so counts stay exact. The hash fuses into this pass
    (`_hash_prefilter`) and is never materialized; survivors carry a
    43-bit composite payload (packed_kmer << 1 | is_rc) + 1, pre-filtered
    lanes u64::MAX.
  * survivor extraction = transposed-sort compaction: sort the
    (STAGE1_H=32, B/32) composite along axis 0 (survivors float to the
    top rows of each column), then re-compact STAGE1_ROWS=4-row slabs
    through a second (STAGE2_H=256, ...) axis-0 sort, and append fixed
    ~32k-entry row-slabs to a spill buffer.
    Slabs page downward inside lax.while_loops until the next row is
    all-MAX, so any survivor density (cold start, bursts, duplicate-heavy
    batches) is covered exactly by the same code path.
  * the spill buffer defers the expensive state merge: appends are
    contiguous dynamic_update_slices; only when the spill fills (or at
    finalize / every scaled step) does a flush rehash the spilled payloads
    and merge them into the sorted state (sort + run-dedup via boundary-
    differenced cumsums + compaction sort). Merge cost amortizes over
    ~SPILL/PAGE batches; between flushes the admission threshold is frozen,
    which only admits a superset (exactness is unaffected; the equilibrium
    is self-balancing because a flush refreshes the threshold).
  * page-wise/flush-wise merging is exact because a hash truncated from the
    state can never re-enter: the state is permanently full of smaller
    hashes from that point on, so later occurrences are pre-filtered out.

State layout (fixed capacity C, spill capacity S; hashes sorted ascending):
    hashes[C] u64 — u64::MAX in empty slots
    counts[C] u64 — 0 in empty slots (saturated to u32 at finalization)
    extras[C] u64 — reverse-complement occurrence counts
    packed[C] u64 — 2-bit packed canonical k-mer codes (payload)
    spill[S]  u64 — composite payloads awaiting merge; u64::MAX when empty
    fill[1]   i32 — spill occupancy
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from finch_tpu.errors import FinchMessageError

from finch_tpu.ops.murmur3 import hash_packed_kmers

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# spill compaction-on-overflow kill switch (A/B ablations / emergency
# disable); exactness never depends on it
SPILL_COMPACT = os.environ.get("FINCH_TPU_SPILL_COMPACT", "1") != "0"

PAGE = 32768       # spill append granularity (entries)
STAGE1_H = 32      # height of the first transposed sort
STAGE1_ROWS = 4    # stage-1 rows re-compacted per stage-2 sort
STAGE2_H = 256     # height of the second transposed sort


def bucket_pow2(n: int, floor: int = 1024) -> int:
    """Next power of two >= n (>= floor): the engines' batch-pad rule, so
    retracing is bounded while small inputs stay small."""
    b = floor
    while b < n:
        b <<= 1
    return b


def spill_capacity(capacity: int) -> int:
    """Spill sized to amortize merges ~8-32x without dwarfing tiny states."""
    return int(max(2 * PAGE, min(1 << 20, 8 * capacity)))


def empty_state(capacity: int, spill: int | None = None):
    if spill is None:
        spill = spill_capacity(capacity)
    return (
        jnp.full((capacity,), U64_MAX, dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.full((spill,), U64_MAX, dtype=jnp.uint64),
        jnp.zeros((1,), dtype=jnp.int32),
    )


def _scan(x, combine):
    """Inclusive log-shift scan. Hand-rolled because the u64
    jnp.cumsum/lax.cummax lowering once exceeded a scratch-memory limit
    at some shapes; whether the library scan is faster on the H100 is an
    open A/B (see _dedup_truncate)."""
    n = x.shape[0]
    d = 1
    while d < n:
        shifted = jnp.concatenate(
            [jnp.zeros((d,), dtype=x.dtype), x[:-d]])
        x = combine(x, shifted)
        d <<= 1
    return x


def _dedup_truncate(h, c, e, pk, out_len: int):
    """h sorted ascending (duplicate runs adjacent; pads have h=U64_MAX,c=0).

    Returns (h, c, e, pk) of length out_len holding the distinct hashes in
    ascending order with summed counts; unused slots (U64_MAX, 0).
    Scatter-free: run totals come from inclusive cumsums differenced at run
    boundaries — the previous run's cumulative total is recovered with a
    cummax over end-masked partial sums (valid because cumsums of
    non-negative counts are monotone), then one compaction sort.

    The kmer payload for a run is taken from its last element; entries of a
    run can only disagree on payload under a 64-bit hash collision, where
    the reference keeps the first-seen kmer (mash.rs:44-50) — an
    unobservable difference in practice.
    """
    is_end = jnp.concatenate([h[1:] != h[:-1], jnp.ones((1,), bool)])

    cs_c = _scan(c, jnp.add)
    cs_e = _scan(e, jnp.add)
    zero = jnp.zeros((1,), dtype=c.dtype)
    prev_c = jnp.concatenate(
        [zero, _scan(jnp.where(is_end, cs_c, 0), jnp.maximum)[:-1]])
    prev_e = jnp.concatenate(
        [zero, _scan(jnp.where(is_end, cs_e, 0), jnp.maximum)[:-1]])
    run_c = cs_c - prev_c
    run_e = cs_e - prev_e

    real = is_end & (run_c > 0)
    kh = jnp.where(real, h, U64_MAX)
    pad_rank = (~real).astype(jnp.uint64)  # real u64::MAX hashes sort first
    kc = jnp.where(real, run_c, 0)
    ke = jnp.where(real, run_e, 0)
    kpk = jnp.where(real, pk, U64_MAX)
    kh, pad_rank, kc, ke, kpk = jax.lax.sort(
        (kh, pad_rank, kc, ke, kpk), num_keys=2)
    return (kh[:out_len], kc[:out_len], ke[:out_len], kpk[:out_len]), (
        kh, kc)


def _merge_candidates(state4, ch, cc, ce, cpk, max_hash):
    """Merge candidates into the 4-array state: sort + dedup + truncate.

    Returns (new_state4, below) where below counts distinct hashes
    <= max_hash in the PRE-truncation merged view — the exact signal the
    scaled driver needs to grow capacity before anything is lost.
    """
    sh, sc, se, spk = state4
    cap = sh.shape[0]
    mh = jnp.concatenate([sh, ch])
    mc = jnp.concatenate([sc, cc])
    me = jnp.concatenate([se, ce])
    mpk = jnp.concatenate([spk, cpk])
    mh, mc, me, mpk = jax.lax.sort((mh, mc, me, mpk), num_keys=1)
    new_state, (full_h, full_c) = _dedup_truncate(mh, mc, me, mpk, cap)
    below = jnp.sum(((full_h <= max_hash) & (full_c > 0)).astype(jnp.uint32))
    return new_state, below


def _spill_weight_shift(k: int) -> int:
    """Bit position of the run-weight field in spill entries.

    A spill entry is (weight << shift) | (composite + 1): the composite
    encoding occupies 2k+2 bits, so the top 64-(2k+2) bits are free to
    carry a duplicate-run weight (stored as run_length - 1, so plain
    entries from every non-aggregating path decode as weight 1). Returns
    0 when k leaves no weight bits (the decode is then a no-op)."""
    s = 2 * k + 2
    return s if s < 64 else 0


def _flush(state4, spill, max_hash, *, k: int, seed: int):
    """Rehash spilled composite payloads and merge them into the state.

    Entries may carry a duplicate-run weight in their top bits (run
    aggregation, spill compaction); count = weight + 1 keeps every path
    exact."""
    ok = spill != U64_MAX
    s = _spill_weight_shift(k)
    if s:
        comp = spill & jnp.uint64((1 << s) - 1)
        w = spill >> jnp.uint64(s)
    else:
        comp = spill
        w = jnp.zeros_like(spill)
    cpk_raw = (comp - jnp.uint64(1)) >> jnp.uint64(1)
    ch = jnp.where(ok, hash_packed_kmers(cpk_raw, k=k, seed=seed), U64_MAX)
    cc = jnp.where(ok, w + jnp.uint64(1), jnp.uint64(0))
    ce = ((comp - jnp.uint64(1)) & jnp.uint64(1)) * cc
    cpk = jnp.where(ok, cpk_raw, U64_MAX)
    return _merge_candidates(state4, ch, cc, ce, cpk, max_hash)


def _compact_spill(spill, *, k: int):
    """Collapse duplicate composites across the WHOLE spill into summed
    run weights (duplicate-burst pressure relief).

    Sorts entries by their composite field (weights masked out of the
    key), sums each run's decoded counts, and re-emits one weighted head
    per distinct composite, compacted to the front with U64_MAX tails.
    Skipping the state merge after a successful compaction is exact: the
    spill still encodes the same multiset of (composite, count) mass, and
    the admission threshold is merely frozen longer, which only admits a
    superset (module docstring invariant).

    Returns (compacted, n_real i32, ovf bool): ovf is set when any run's
    total would not fit the weight field (the caller must fall back to a
    real flush, which moves counts into the u64 count arrays).
    """
    s = _spill_weight_shift(k)
    mask = jnp.uint64((1 << s) - 1)
    real_in = spill != U64_MAX
    key, ent = jax.lax.sort(
        (jnp.where(real_in, spill & mask, U64_MAX), spill), num_keys=1)
    real = key != U64_MAX
    w = jnp.where(real, (ent >> jnp.uint64(s)) + jnp.uint64(1),
                  jnp.uint64(0))
    is_end = jnp.concatenate([key[1:] != key[:-1], jnp.ones((1,), bool)])
    cs = _scan(w, jnp.add)
    prev = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint64),
         _scan(jnp.where(is_end, cs, 0), jnp.maximum)[:-1]])
    total = cs - prev
    keep = is_end & real
    ovf = jnp.any(
        keep & (((total - jnp.uint64(1)) >> jnp.uint64(64 - s))
                != jnp.uint64(0)))
    out = jnp.where(
        keep, key + ((total - jnp.uint64(1)) << jnp.uint64(s)), U64_MAX)
    # compact heads to the front (key is unique per run, so one sort key
    # suffices; non-heads carry U64_MAX keys and sink to the tail)
    _, out = jax.lax.sort((jnp.where(keep, key, U64_MAX), out), num_keys=1)
    n_real = jnp.sum(keep, dtype=jnp.int32)
    return out, n_real, ovf


def _compact_worthwhile(k: int) -> bool:
    """Static gate: spill compaction needs a weight field wide enough for
    real duplicate-burst run totals (>= 12 bits, k <= 25)."""
    s = _spill_weight_shift(k)
    return bool(s) and (64 - s) >= 12


def _aggregate_runs(s2, shift: int):
    """Collapse duplicate composites in a column-sorted slab into weighted
    run heads (duplicate-burst pre-aggregation).

    After the stage-2 axis-0 sort, copies of one value sit at nearly the
    same row of different columns (rank ~ value quantile, Poisson-narrow);
    a last-axis row sort therefore colocates them into in-row runs. Each
    run is replaced by its head entry carrying (run_length - 1) in the
    top weight bits; non-heads become U64_MAX. The final axis-0 sort
    floats real entries back to the top rows for the paging loop.

    Exact for any input: every real entry belongs to exactly one in-row
    run, runs never span rows/pages (those split into separately-weighted
    heads the flush merge re-sums), and the caller gates on the weight
    field being wide enough for the worst-case run (a full row)."""
    H, w = s2.shape
    s = jax.lax.sort(s2, dimension=1)
    neq = s[:, 1:] != s[:, :-1]
    head = jnp.concatenate([jnp.ones((H, 1), bool), neq], 1)
    endm = jnp.concatenate([neq, jnp.ones((H, 1), bool)], 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, w), 1)
    big = jnp.int32(2 ** 31 - 1)
    e = jnp.where(endm, col, big)
    d = 1
    while d < w:  # suffix-min: nearest run end at or after each column
        e = jnp.minimum(e, jnp.concatenate(
            [e[:, d:], jnp.full((H, d), big, jnp.int32)], 1))
        d <<= 1
    run = (e - col).astype(jnp.uint64)  # run_length - 1 at run heads
    keep = head & (s != U64_MAX)
    out = jnp.where(keep, s + (run << jnp.uint64(shift)), U64_MAX)
    return jax.lax.sort(out, dimension=0)


def _append_page(carry, cand, mh_arg, *, k: int, seed: int,
                 compact: bool = False):
    """Append one candidate page to the spill, flushing first if needed.

    The flush cond's outputs are kept to the 4 state arrays + a scalar:
    conditional outputs are copied by XLA's buffer assignment, so routing
    the (larger) spill reset through an elementwise where instead of the
    cond measurably cuts per-step overhead.

    compact=True (duplicate-burst streams): on overflow, first try to
    collapse duplicate composites across the spill into summed weights;
    when that frees >= 25% of the spill (and no weight overflows), the
    expensive state merge is skipped entirely — dup-heavy streams then
    pay one 2-array sort per overflow instead of a full 5-array
    state+spill merge, and overflows themselves become rarer because the
    compacted entries keep absorbing later duplicates.
    """
    state4, spill, fill, below = carry
    need = cand.shape[0]
    sp = spill.shape[0]
    must = fill[0] + need > sp

    if compact and _compact_worthwhile(k):
        def try_compact(spl):
            out, n_real, ovf = _compact_spill(spl, k=k)
            good = (~ovf) & (n_real + need <= sp - sp // 4)
            return out, n_real, good

        def no_compact(spl):
            return spl, fill[0], jnp.zeros((), bool)

        spl_c, n_c, good = jax.lax.cond(must, try_compact, no_compact,
                                        spill)
        use_flush = must & ~good
        use_comp = must & good
    else:
        use_flush = must
        use_comp = jnp.zeros((), bool)
        spl_c, n_c = spill, fill[0]

    def do_flush(args):
        st4, spl = args
        nst, nb = _flush(st4, spl, mh_arg, k=k, seed=seed)
        return nst, nb.astype(jnp.uint32)

    def no_flush(args):
        st4, spl = args
        # zero derived from the data so sharding varying-axes match the
        # flush branch under shard_map
        return st4, (spl[0] - spl[0]).astype(jnp.uint32)

    state4, nb = jax.lax.cond(use_flush, do_flush, no_flush,
                              (state4, spill))
    below = jnp.maximum(below, nb)
    spill = jnp.where(use_flush, U64_MAX,
                      jnp.where(use_comp, spl_c, spill))
    fill = jnp.where(use_flush, jnp.zeros_like(fill),
                     jnp.where(use_comp, jnp.zeros_like(fill) + n_c,
                               fill))
    spill = jax.lax.dynamic_update_slice(spill, cand, (fill[0],))
    return state4, spill, fill + need, below


def _hash_prefilter(batch_packed, batch_rc, valid, thresh, *, k: int,
                    seed: int):
    """Hash + prefilter + composite, fused by XLA into one elementwise
    pass: (packed << 1 | rc) + 1 where the hash is <= thresh, else
    U64_MAX."""
    h = hash_packed_kmers(batch_packed, k=k, seed=seed)
    keep = valid & (h <= thresh)
    return jnp.where(
        keep,
        ((batch_packed.astype(jnp.uint64) << jnp.uint64(1))
         | batch_rc.astype(jnp.uint64)) + jnp.uint64(1),
        U64_MAX)


def sketch_step(state, batch_packed, batch_rc, nvalid, max_hash,
                *, k: int, seed: int, has_max_hash: bool,
                composite: bool = False, xla_aggregate: bool = False,
                spill_compact: bool | None = None):
    """Fold one batch into the sketch state (see _sketch_step).

    Thin wrapper resolving the spill_compact default OUTSIDE the jit
    cache so the module-level env flag is always part of the key."""
    if spill_compact is None:
        spill_compact = SPILL_COMPACT
    return _sketch_step(
        state, batch_packed, batch_rc, nvalid, max_hash, k=k, seed=seed,
        has_max_hash=has_max_hash, composite=composite,
        xla_aggregate=xla_aggregate, spill_compact=spill_compact)


@partial(jax.jit, static_argnames=("k", "seed", "has_max_hash",
                                   "composite", "xla_aggregate",
                                   "spill_compact"))
def _sketch_step(state, batch_packed, batch_rc, nvalid, max_hash,
                 *, k: int, seed: int, has_max_hash: bool,
                 composite: bool = False, xla_aggregate: bool = False,
                 spill_compact: bool = True):
    """Fold one batch of packed canonical k-mers into the sketch state.

    Exact for any input (cold state, survivor bursts, duplicates) via
    transposed-sort compaction + spill — see the module docstring. Returns
    (new_state, below_count): below_count is the max, over flushes this
    step, of the number of distinct hashes <= max_hash in the
    pre-truncation merged view (scaled capacity-growth signal: any
    truncation loss forces below_count > capacity, so the driver's
    grow-and-redo rail always fires before data is lost). When
    has_max_hash, below is the upper bound (distinct below-threshold state
    hashes) + (real spill entries) — see the scaled note below; the spill
    is NOT flushed every step.

    xla_aggregate turns duplicate-run aggregation and spill compaction on
    (exact either way; CPU-tested, off by default).
    """
    sh, sc, se, spk, spill, fill = state
    state4 = (sh, sc, se, spk)
    b = batch_packed.shape[0]
    if composite:
        # inputs are the parser's ((packed << 1) | is_rc) u32 planes
        # (batch_packed = lo, batch_rc = hi); reconstruct the u64 form
        comp64 = ((batch_rc.astype(jnp.uint64) << jnp.uint64(32))
                  | batch_packed.astype(jnp.uint64))
        batch_rc = (batch_packed & jnp.uint32(1)).astype(jnp.uint8)
        batch_packed = comp64 >> jnp.uint64(1)
    if b > (1 << 25):
        # a stage-2 page is b/1024 entries wide; past 32M lanes a single
        # page would overflow the spill. Engines batch at 2-4M.
        raise FinchMessageError("sketch_step batches are limited to 32M lanes; "
                         "split the batch")

    valid = jnp.arange(b, dtype=jnp.uint32) < nvalid.astype(jnp.uint32)
    thresh = sh[-1]
    if has_max_hash:
        thresh = jnp.maximum(thresh, max_hash.astype(jnp.uint64))
    mh_arg = (max_hash.astype(jnp.uint64) if has_max_hash
              else jnp.uint64(0))

    below0 = (fill[0] - fill[0]).astype(jnp.uint32)
    carry0 = (state4, spill, fill, below0)

    two_stage = b >= STAGE1_H * STAGE2_H * 16 and b % (4096 * STAGE1_ROWS) == 0

    def xla_comp():
        return _hash_prefilter(batch_packed, batch_rc, valid, thresh, k=k,
                               seed=seed)

    def stage2_pages(carry, flat_cands, aggregate=False, compact=False):
        """Re-compact candidates through a (STAGE2_H, w2) axis-0 sort and
        append row pages while the next page's leading row has survivors.

        aggregate=True (duplicate-heavy batches) additionally collapses
        duplicate runs into weighted heads between the sort and the
        paging, when k leaves enough weight bits for a full-row run.
        compact=True arms spill compaction-on-overflow in the appends."""
        w2 = flat_cands.shape[0] // STAGE2_H
        # r2 must divide STAGE2_H or the tail rows would never be paged;
        # STAGE2_H is a power of two, so take the largest power of two
        # within the page budget
        r2 = 1
        while r2 * 2 <= min(STAGE2_H, PAGE // w2):
            r2 *= 2
        n2 = STAGE2_H // r2
        s2 = jax.lax.sort(flat_cands.reshape(STAGE2_H, w2), dimension=0)
        shift = _spill_weight_shift(k)
        if (aggregate and shift
                and 64 - shift >= max(1, (w2 - 1).bit_length())):
            s2 = _aggregate_runs(s2, shift)

        # s2 is loop-invariant: close over it instead of carrying it (a
        # while carry is double-buffered and copied every iteration)
        def iw_body(c):
            p2, carry = c
            cand = jax.lax.dynamic_slice(
                s2, (p2 * r2, jnp.int32(0)), (r2, w2)).ravel()
            return (p2 + jnp.int32(1),
                    _append_page(carry, cand, mh_arg, k=k, seed=seed,
                                 compact=compact))

        def iw_cond(c):
            p2, _ = c
            return (p2 < n2) & jnp.any(
                jax.lax.dynamic_slice(
                    s2, (p2 * r2, jnp.int32(0)), (1, w2)) != U64_MAX)

        _, carry = jax.lax.while_loop(
            iw_cond, iw_body, (jnp.int32(0), carry))
        return carry

    def run_two_stage(carry, aggregate=False, compact=False):
        comp = xla_comp()
        w1 = b // STAGE1_H
        s1 = jax.lax.sort(comp.reshape(STAGE1_H, w1), dimension=0)
        n1 = STAGE1_H // STAGE1_ROWS

        def outer(carry_p1):
            carry, p1 = carry_p1
            block = jax.lax.dynamic_slice(
                s1, (p1 * STAGE1_ROWS, jnp.int32(0)), (STAGE1_ROWS, w1))
            carry = stage2_pages(carry, block.ravel(), aggregate=aggregate,
                                 compact=compact)
            return carry, p1 + jnp.int32(1)

        def outer_cond(carry_p1):
            _, p1 = carry_p1
            return (p1 < n1) & jnp.any(
                jax.lax.dynamic_slice(
                    s1, (p1 * STAGE1_ROWS, jnp.int32(0)),
                    (1, w1)) != U64_MAX)

        carry, _ = jax.lax.while_loop(outer_cond, outer,
                                      (carry, jnp.int32(0)))
        return carry

    def run_small(carry):
        comp = xla_comp()
        s1 = jax.lax.sort(comp)
        page = min(b, PAGE)
        npages = (b + page - 1) // page
        if npages * page != b:
            # pad so dynamic_slice never clamps into an already-appended
            # region (a clamped overlap would double-count survivors)
            s1 = jnp.concatenate(
                [s1, jnp.full((npages * page - b,), U64_MAX,
                              dtype=jnp.uint64)])

        def body(carry_p):
            carry, p = carry_p
            cand = jax.lax.dynamic_slice(s1, (p * page,), (page,))
            return (_append_page(carry, cand, mh_arg, k=k, seed=seed),
                    p + jnp.int32(1))

        def cond(carry_p):
            _, p = carry_p
            return (p < npages) & (
                jax.lax.dynamic_slice(s1, (p * page,), (1,))[0] != U64_MAX)

        carry, _ = jax.lax.while_loop(cond, body, (carry, jnp.int32(0)))
        return carry

    if two_stage:
        (state4, spill, fill, below) = run_two_stage(
            carry0, aggregate=xla_aggregate,
            compact=xla_aggregate and spill_compact)
    else:
        (state4, spill, fill, below) = run_small(carry0)

    if has_max_hash:
        # scaled sketching needs a below-count every step for the driver's
        # grow rail. Instead of flushing the spill each step, return the
        # conservative upper bound (distinct <= max_hash in the state) +
        # (spill occupancy): if the bound stays <= capacity - size, the
        # eventual flush cannot truncate a below-threshold hash, so
        # exactness is preserved while merges amortize as in the mash path.
        nsh, nsc = state4[0], state4[1]
        below_state = jnp.sum(
            ((nsh <= mh_arg) & (nsc > 0)).astype(jnp.uint32))
        # count real spill entries, not consumed slots — pages are mostly
        # U64_MAX padding at low density and would inflate the bound by
        # the whole spill capacity
        spill_real = jnp.sum((spill != U64_MAX).astype(jnp.uint32))
        below = jnp.maximum(below, below_state + spill_real)
    else:
        below = below0

    return (*state4, spill, fill), below


@partial(jax.jit, static_argnames=("k", "seed"))
def flush_state(state, max_hash, *, k: int, seed: int):
    """Merge any spilled candidates into the state (finalize barrier)."""
    sh, sc, se, spk, spill, fill = state
    state4, below = _flush((sh, sc, se, spk), spill, max_hash, k=k,
                           seed=seed)
    return (*state4, jnp.full_like(spill, U64_MAX), jnp.zeros_like(fill)), \
        below


@jax.jit
def grow_state(state, new_capacity_template):
    """Copy state into a larger capacity buffer (scaled scheme growth).

    Grows the 4 sorted arrays and carries the spill contents over (the
    template's spill may be larger; spill_capacity is monotone in
    capacity, so the old contents always fit)."""
    nh, nc, ne, npk, nspill, _ = new_capacity_template
    sh, sc, se, spk, spill, fill = state
    n = sh.shape[0]
    m = spill.shape[0]
    return (
        nh.at[:n].set(sh),
        nc.at[:n].set(sc),
        ne.at[:n].set(se),
        npk.at[:n].set(spk),
        nspill.at[:m].set(spill),
        fill,
    )


def merge_states(states, *, k: int, seed: int):
    """Associative merge of per-shard sketch states (same capacity).

    Used by the multi-device path: partial bottom-k states from different
    data shards merge exactly (counts add on equal hashes). Each state's
    spill is flushed first.
    """
    flushed = []
    for s in states:
        s4, _ = _flush((s[0], s[1], s[2], s[3]), s[4], jnp.uint64(0),
                       k=k, seed=seed)
        flushed.append(s4)
    h = jnp.concatenate([s[0] for s in flushed])
    c = jnp.concatenate([s[1] for s in flushed])
    e = jnp.concatenate([s[2] for s in flushed])
    pk = jnp.concatenate([s[3] for s in flushed])
    h, c, e, pk = jax.lax.sort((h, c, e, pk), num_keys=1)
    cap = states[0][0].shape[0]
    merged, _ = _dedup_truncate(h, c, e, pk, cap)
    return (*merged, jnp.full_like(states[0][4], U64_MAX),
            jnp.zeros_like(states[0][5]))
