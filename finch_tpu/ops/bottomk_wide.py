"""Batched bottom-k for WIDE k-mers (32 <= k <= 63) — two-word payloads.

The reference hashes the ASCII bytes of canonical k-mers with no upper
bound on k (/root/reference/lib/src/sketch_schemes/hashing.rs:9-12;
needletail's canonical_kmers works on byte slices of any k, mash.rs:73-79).
The narrow engine (ops/bottomk.py) encodes its spill composites as single
u64 words, which caps it at k <= 31; this module extends the device path to
the long-kmer range with a simpler, payload-carrying design:

  * candidates carry (hash u64, packed_lo u64, packed_hirc u64) — the hash
    is computed once and carried (no rehash-at-flush), and the second
    payload word packs (packed_hi << 2 | is_rc << 1 | 1) so bit 0 doubles
    as the is-real marker (packed_hi < 2^(2k-64) <= 2^62 for k <= 63).
  * each step sorts the batch by hash, run-dedups it with summed counts
    (the log-shift scan trick from ops/bottomk.py — cumsums differenced at
    run boundaries), truncates to capacity, and merges into the state with
    one more sort + dedup. Exact by the same monotone-max theorem: only
    the `capacity` smallest distinct hashes of a batch can ever reach the
    final sketch, and truncation is permanent.

No spill buffer: wide k is a capability path (long-kmer
metagenomics), not the throughput headline; per-batch cost is two sorts.
Same batch-equivalence contracts as ops/bottomk.py; property-tested against
models/oracle.py in tests/test_wide_k.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from finch_tpu.ops.murmur3 import hash_packed_kmers_wide

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def empty_state(capacity: int):
    """(h, c, e, plo, phirc): sorted-ascending hash state; empty slots have
    h = u64::MAX, c = 0, phirc = 0 (bit 0 = is-real marker)."""
    return (
        jnp.full((capacity,), U64_MAX, dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
        jnp.zeros((capacity,), dtype=jnp.uint64),
    )


def _scan(x, combine):
    """Log-shift inclusive scan (see ops/bottomk.py:_scan)."""
    n = x.shape[0]
    d = 1
    while d < n:
        shifted = jnp.concatenate([jnp.zeros((d,), dtype=x.dtype), x[:-d]])
        x = combine(x, shifted)
        d <<= 1
    return x


def _dedup_truncate_wide(h, c, e, plo, phirc, out_len: int):
    """h sorted ascending; returns arrays of length out_len with distinct
    hashes ascending, counts/extras summed per run, payload from the run's
    last element (64-bit-collision payload choice is unobservable — see
    ops/bottomk.py). Also returns the full pre-truncation (h, c) view."""
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
    kplo = jnp.where(real, plo, 0)
    kphirc = jnp.where(real, phirc, 0)
    kh, pad_rank, kc, ke, kplo, kphirc = jax.lax.sort(
        (kh, pad_rank, kc, ke, kplo, kphirc), num_keys=2)
    return (kh[:out_len], kc[:out_len], ke[:out_len], kplo[:out_len],
            kphirc[:out_len]), (kh, kc)


@partial(jax.jit, static_argnames=("k", "seed", "has_max_hash"))
def sketch_step(state, batch_plo, batch_phi, batch_rc, nvalid, max_hash,
                *, k: int, seed: int, has_max_hash: bool):
    """Fold one batch of wide packed canonical k-mers into the state.

    Returns (new_state, below): below is the number of distinct hashes
    <= max_hash in the pre-truncation merged view (the scaled driver's
    grow-and-redo signal, same contract as ops/bottomk.sketch_step)."""
    sh, sc, se, splo, sphirc = state
    cap = sh.shape[0]
    b = batch_plo.shape[0]

    h = hash_packed_kmers_wide(batch_plo, batch_phi, k=k, seed=seed)
    valid = jnp.arange(b, dtype=jnp.uint32) < nvalid.astype(jnp.uint32)
    thresh = sh[-1]
    mh = max_hash.astype(jnp.uint64) if has_max_hash else jnp.uint64(0)
    if has_max_hash:
        thresh = jnp.maximum(thresh, mh)
    keep = valid & (h <= thresh)

    ch = jnp.where(keep, h, U64_MAX)
    cc = keep.astype(jnp.uint64)
    ce = batch_rc.astype(jnp.uint64) * cc
    cplo = jnp.where(keep, batch_plo.astype(jnp.uint64), 0)
    cphirc = jnp.where(
        keep,
        (batch_phi.astype(jnp.uint64) << jnp.uint64(2))
        | (batch_rc.astype(jnp.uint64) << jnp.uint64(1)) | jnp.uint64(1),
        0)

    # batch-local dedup to capacity: only the cap smallest distinct batch
    # hashes can affect the state (truncation permanence)
    ch, cc, ce, cplo, cphirc = jax.lax.sort(
        (ch, cc, ce, cplo, cphirc), num_keys=1)
    (bh, bc, be, bplo, bphirc), _ = _dedup_truncate_wide(
        ch, cc, ce, cplo, cphirc, cap)

    # merge into the state
    mh_arr = jnp.concatenate([sh, bh])
    mc = jnp.concatenate([sc, bc])
    me = jnp.concatenate([se, be])
    mplo = jnp.concatenate([splo, bplo])
    mphirc = jnp.concatenate([sphirc, bphirc])
    mh_arr, mc, me, mplo, mphirc = jax.lax.sort(
        (mh_arr, mc, me, mplo, mphirc), num_keys=1)
    new_state, (full_h, full_c) = _dedup_truncate_wide(
        mh_arr, mc, me, mplo, mphirc, cap)
    below = jnp.sum(((full_h <= mh) & (full_c > 0)).astype(jnp.uint32))
    return new_state, below


def grow_state(state, new_capacity: int):
    """Copy into a larger-capacity state (scaled growth rail)."""
    out = list(empty_state(new_capacity))
    n = state[0].shape[0]
    for i in range(5):
        out[i] = out[i].at[:n].set(state[i])
    return tuple(out)


def state_arrays(state):
    """(h, c, e, plo, phi, rc) numpy views of the live entries, ascending
    hash (the phirc word decodes back into packed_hi and is_rc)."""
    h = np.asarray(state[0])
    c = np.asarray(state[1])
    e = np.asarray(state[2])
    plo = np.asarray(state[3])
    phirc = np.asarray(state[4])
    real = c > 0
    phi = (phirc >> np.uint64(2))
    return (h[real], c[real], e[real], plo[real], phi[real])


def merge_states(states):
    """Associative merge of per-shard wide states (same capacity)."""
    h = jnp.concatenate([s[0] for s in states])
    c = jnp.concatenate([s[1] for s in states])
    e = jnp.concatenate([s[2] for s in states])
    plo = jnp.concatenate([s[3] for s in states])
    phirc = jnp.concatenate([s[4] for s in states])
    h, c, e, plo, phirc = jax.lax.sort((h, c, e, plo, phirc), num_keys=1)
    cap = states[0][0].shape[0]
    merged, _ = _dedup_truncate_wide(h, c, e, plo, phirc, cap)
    return merged
