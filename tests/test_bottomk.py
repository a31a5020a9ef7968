"""Batched bottom-k device step (ops/bottomk.py): the run/spill
machinery in isolation, and sketch_step end to end against the host
oracle (NumpyEngine) in every stream regime the device path meets."""

import zlib

import numpy as np
import pytest

from finch_tpu.models.engine import JaxEngine, NumpyEngine
from finch_tpu.models.params import SketchParams
from finch_tpu.ops import bottomk

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
SMALL_B = 1 << 14   # run_small: one sort + pages
TWO_STAGE_B = 1 << 17  # smallest batch on the two-stage transposed sort


def test_sketch_step_composite_equals_classic():
    """Composite u32-plane input (the parser's fn_next_batch_c format)
    must produce bit-identical states to the classic (packed, rc) form."""
    import jax.numpy as jnp
    import numpy as np

    from finch_tpu.ops import bottomk

    rng = np.random.default_rng(8)
    cap, b = 512, 1 << 14
    s1 = bottomk.empty_state(cap)
    s2 = bottomk.empty_state(cap)
    for step in range(3):
        pk = rng.integers(0, 4 ** 21, size=b, dtype=np.uint64)
        pk[: b // 8] = pk[b // 8: b // 4]  # duplicates
        rc = rng.integers(0, 2, size=b, dtype=np.uint8)
        comp = (pk << np.uint64(1)) | rc
        lo = (comp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (comp >> np.uint64(32)).astype(np.uint32)
        nv = jnp.uint32(b - 7 if step else b)
        s1, _ = bottomk.sketch_step(
            s1, jnp.asarray(pk), jnp.asarray(rc), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False)
        s2, _ = bottomk.sketch_step(
            s2, jnp.asarray(lo), jnp.asarray(hi), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False, composite=True)
    f1, _ = bottomk.flush_state(s1, jnp.uint64(0), k=21, seed=0)
    f2, _ = bottomk.flush_state(s2, jnp.uint64(0), k=21, seed=0)
    for a, b2 in zip(f1[:4], f2[:4]):
        assert np.array_equal(np.asarray(a), np.asarray(b2))


def test_aggregate_runs_preserves_weighted_multiset():
    """_aggregate_runs must conserve the total occurrence count of every
    composite (run heads carry run_length-1 in the weight bits) and emit
    only real entries above U64_MAX padding after its compaction sort."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    k = 21
    shift = bottomk._spill_weight_shift(k)
    rng = np.random.default_rng(3)
    H, w = 64, 256
    vals = rng.integers(1, 1000, size=(H, w)).astype(np.uint64)
    # heavy duplication + padding
    vals[vals % 3 == 0] = 42
    pad = rng.random((H, w)) < 0.3
    vals[pad] = U64_MAX
    s2 = np.sort(vals, axis=0)  # column-sorted, as stage2 provides

    out = np.asarray(bottomk._aggregate_runs(jnp.asarray(s2), shift))
    mask = np.uint64((1 << shift) - 1)
    real = out[out != U64_MAX]
    got = {}
    for e in real:
        got[int(e & mask)] = got.get(int(e & mask), 0) + int(e >> shift) + 1
    exp = {}
    for e in vals[vals != U64_MAX]:
        exp[int(e)] = exp.get(int(e), 0) + 1
    assert got == exp
    # compaction: every real entry sits above the first all-MAX row
    col_real = (out != U64_MAX)
    assert np.array_equal(np.sort(col_real, axis=0)[::-1], col_real)


def test_weighted_spill_flush_exact():
    """_flush must decode run weights from spill entries: a weighted head
    equals that many plain duplicates, bit for bit."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    k = 21
    shift = bottomk._spill_weight_shift(k)
    rng = np.random.default_rng(9)
    pk = rng.integers(0, 4 ** k, size=64, dtype=np.uint64)
    rc = rng.integers(0, 2, size=64, dtype=np.uint64)
    comp = ((pk << np.uint64(1)) | rc) + np.uint64(1)
    weights = rng.integers(1, 7, size=64).astype(np.uint64)

    cap = 32
    spill_w = np.full(256, U64_MAX, dtype=np.uint64)
    spill_w[:64] = comp + ((weights - 1) << np.uint64(shift))
    plain = np.full(1024, U64_MAX, dtype=np.uint64)
    pos = 0
    for c, wt in zip(comp, weights):
        plain[pos:pos + int(wt)] = c
        pos += int(wt)

    s4 = (jnp.full((cap,), U64_MAX, dtype=jnp.uint64),
          jnp.zeros((cap,), dtype=jnp.uint64),
          jnp.zeros((cap,), dtype=jnp.uint64),
          jnp.zeros((cap,), dtype=jnp.uint64))
    a, _ = bottomk._flush(s4, jnp.asarray(spill_w), jnp.uint64(0),
                          k=k, seed=0)
    b, _ = bottomk._flush(s4, jnp.asarray(plain), jnp.uint64(0),
                          k=k, seed=0)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_compact_spill_preserves_count_mass():
    """_compact_spill must re-encode the spill's exact (composite ->
    total count) multiset as one weighted head per distinct composite,
    compacted to the front in ascending composite order."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    k = 21
    s = bottomk._spill_weight_shift(k)
    rng = np.random.default_rng(5)
    comp = np.unique(
        rng.integers(1, 1 << (2 * k + 1), size=50, dtype=np.uint64))
    entries = []
    want = {}
    for c in comp:
        for _ in range(int(rng.integers(1, 6))):
            w = int(rng.integers(1, 9))
            entries.append(np.uint64(c) + (np.uint64(w - 1) << np.uint64(s)))
            want[int(c)] = want.get(int(c), 0) + w
    rng.shuffle(entries)
    spill = np.full(512, U64_MAX, dtype=np.uint64)
    # interspersed U64_MAX holes (page-padding pattern)
    pos = rng.choice(512, size=len(entries), replace=False)
    spill[pos] = entries

    out, n_real, ovf = bottomk._compact_spill(jnp.asarray(spill), k=k)
    out = np.asarray(out)
    assert not bool(ovf)
    assert int(n_real) == len(want)
    got = out[: int(n_real)]
    assert np.all(out[int(n_real):] == U64_MAX)
    mask = np.uint64((1 << s) - 1)
    got_comp = got & mask
    got_w = (got >> np.uint64(s)).astype(np.int64) + 1
    assert np.array_equal(got_comp, np.sort(np.array(sorted(want),
                                                     dtype=np.uint64)))
    assert {int(c): int(w) for c, w in zip(got_comp, got_w)} == want


def test_compact_spill_weight_overflow_flag():
    """Run totals that exceed the weight field must set ovf (the caller
    then falls back to a real flush instead of losing count mass)."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    k = 21
    s = bottomk._spill_weight_shift(k)
    width = 64 - s
    near_max = (1 << width) - 1  # stored weight cap (count near_max + 1)
    spill = np.full(64, U64_MAX, dtype=np.uint64)
    c = np.uint64(123457)
    spill[0] = c + (np.uint64(near_max) << np.uint64(s))
    spill[1] = c  # +1 more pushes the total past the field
    out, n_real, ovf = bottomk._compact_spill(jnp.asarray(spill), k=k)
    assert bool(ovf)
    # a second composite with a fitting total stays exact
    spill2 = np.full(64, U64_MAX, dtype=np.uint64)
    spill2[0] = c + (np.uint64(near_max - 1) << np.uint64(s))
    spill2[1] = c
    out2, n2, ovf2 = bottomk._compact_spill(jnp.asarray(spill2), k=k)
    assert not bool(ovf2)
    assert int(n2) == 1
    assert int(np.asarray(out2)[0] >> np.uint64(s)) == near_max


def test_dup_burst_xla_aggregation_end_to_end():
    """Full sketch_step with duplicate-run aggregation (xla_aggregate):
    a 64x-duplicate burst stream must produce bit-identical state to the
    plain path, counts included."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    rng = np.random.default_rng(21)
    cap, b = 2000, 1 << 17  # two_stage threshold is 128k lanes
    s_agg = bottomk.empty_state(cap)
    s_plain = bottomk.empty_state(cap)
    for step in range(3):
        base = rng.integers(0, 4 ** 21, size=b // 64, dtype=np.uint64)
        pk = np.tile(base, 64)
        rc = np.tile(rng.integers(0, 2, size=b // 64, dtype=np.uint8), 64)
        nv = jnp.uint32(b)
        s_agg, _ = bottomk.sketch_step(
            s_agg, jnp.asarray(pk), jnp.asarray(rc), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False, xla_aggregate=True)
        s_plain, _ = bottomk.sketch_step(
            s_plain, jnp.asarray(pk), jnp.asarray(rc), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False)
    f1, _ = bottomk.flush_state(s_agg, jnp.uint64(0), k=21, seed=0)
    f2, _ = bottomk.flush_state(s_plain, jnp.uint64(0), k=21, seed=0)
    for a, b2 in zip(f1[:4], f2[:4]):
        assert np.array_equal(np.asarray(a), np.asarray(b2))
    # counts really reflect the 64x duplication
    counts = np.asarray(f1[1])
    assert counts.max() >= 64


def test_spill_compaction_end_to_end_extreme_duplication():
    """A 4096x-duplicate stream (32 distinct composites per 128k batch,
    cold cap so the admission threshold never tightens) overflows the
    spill every step; compaction-on-overflow must absorb the bursts into
    weighted heads WITHOUT state merges, stay bit-exact vs the plain
    path, and leave a visibly compacted spill (few entries, run weights
    far above what per-page run aggregation alone could produce)."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    rng = np.random.default_rng(77)
    cap, b, ndist = 2000, 1 << 17, 32
    s_c = bottomk.empty_state(cap)
    s_plain = bottomk.empty_state(cap)
    base = rng.integers(0, 4 ** 21, size=ndist, dtype=np.uint64)
    rcb = rng.integers(0, 2, size=ndist, dtype=np.uint8)
    for step in range(4):
        pk = np.tile(base, b // ndist)
        rc = np.tile(rcb, b // ndist)
        nv = jnp.uint32(b)
        s_c, _ = bottomk.sketch_step(
            s_c, jnp.asarray(pk), jnp.asarray(rc), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False, xla_aggregate=True)
        s_plain, _ = bottomk.sketch_step(
            s_plain, jnp.asarray(pk), jnp.asarray(rc), nv, jnp.uint64(0),
            k=21, seed=0, has_max_hash=False)
    # engagement proof: compaction leaves heads whose run weights span
    # MANY pages (per-page run aggregation alone is bounded by the
    # stage-2 row width, 63 here), plus at most the pages appended since
    # the last compaction
    spill = np.asarray(s_c[4])
    real = spill[spill != U64_MAX]
    shift = bottomk._spill_weight_shift(21)
    assert len(real) <= ndist + (1 << 17) // 8
    assert int((real >> np.uint64(shift)).max()) + 1 >= 4096
    f1, _ = bottomk.flush_state(s_c, jnp.uint64(0), k=21, seed=0)
    f2, _ = bottomk.flush_state(s_plain, jnp.uint64(0), k=21, seed=0)
    for a, b2 in zip(f1[:4], f2[:4]):
        assert np.array_equal(np.asarray(a), np.asarray(b2))
    counts = np.asarray(f1[1])
    assert counts.max() >= 4 * (b // ndist)


def test_spill_compaction_scaled_path_exact_and_bound_valid():
    """Scaled sketching (has_max_hash) under duplicate bursts: compaction
    must keep the final state bit-exact AND the per-step below-bound an
    upper bound of the true distinct-below-max_hash count (the grow
    rail's exactness precondition)."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    rng = np.random.default_rng(31)
    cap, b, ndist = 2000, 1 << 17, 512
    max_hash = jnp.uint64(int(0.25 * 2 ** 64))
    s_c = bottomk.empty_state(cap)
    s_plain = bottomk.empty_state(cap)
    base = rng.integers(0, 4 ** 21, size=ndist, dtype=np.uint64)
    rcb = rng.integers(0, 2, size=ndist, dtype=np.uint8)
    below_c = below_p = None
    for step in range(4):
        pk = np.tile(base, b // ndist)
        rc = np.tile(rcb, b // ndist)
        nv = jnp.uint32(b)
        s_c, below_c = bottomk.sketch_step(
            s_c, jnp.asarray(pk), jnp.asarray(rc), nv, max_hash,
            k=21, seed=0, has_max_hash=True, xla_aggregate=True)
        s_plain, below_p = bottomk.sketch_step(
            s_plain, jnp.asarray(pk), jnp.asarray(rc), nv, max_hash,
            k=21, seed=0, has_max_hash=True)
    f1, _ = bottomk.flush_state(s_c, max_hash, k=21, seed=0)
    f2, _ = bottomk.flush_state(s_plain, max_hash, k=21, seed=0)
    for a, b2 in zip(f1[:4], f2[:4]):
        assert np.array_equal(np.asarray(a), np.asarray(b2))
    # true distinct below-threshold count from the flushed state
    h, c = np.asarray(f1[0]), np.asarray(f1[1])
    true_below = int(((h <= np.uint64(int(max_hash))) & (c > 0)).sum())
    assert int(below_c) >= true_below
    # compaction only tightens the bound (fewer spill entries), never
    # below the truth
    assert int(below_c) <= int(below_p)



def _regime_batches(regime: str, b: int, rng):
    """Three (packed u64, rc u8) batches of the named stream regime."""
    out = []
    base = rng.integers(0, 4 ** 21, size=32, dtype=np.uint64)
    base_rc = rng.integers(0, 2, size=32, dtype=np.uint8)
    for _ in range(1 if regime == "cold" else 3):
        if regime in ("cold", "uniform", "scaled"):
            pk = rng.integers(0, 4 ** 21, size=b, dtype=np.uint64)
            rc = rng.integers(0, 2, size=b, dtype=np.uint8)
        elif regime in ("tiled_dup", "shuffled_dup"):
            pk = np.tile(rng.integers(0, 4 ** 21, size=b // 64,
                                      dtype=np.uint64), 64)
            rc = np.tile(rng.integers(0, 2, size=b // 64, dtype=np.uint8),
                         64)
            if regime == "shuffled_dup":
                perm = rng.permutation(b)
                pk, rc = pk[perm], rc[perm]
        else:  # extreme_dup: 32 distinct k-mers per batch
            pk = np.tile(base, b // 32)
            rc = np.tile(base_rc, b // 32)
        out.append((pk, rc))
    return out


@pytest.mark.parametrize("b", [SMALL_B, TWO_STAGE_B],
                         ids=["run_small", "two_stage"])
@pytest.mark.parametrize("composite", [False, True],
                         ids=["classic", "composite"])
@pytest.mark.parametrize("regime", ["cold", "uniform", "tiled_dup",
                                    "shuffled_dup", "extreme_dup",
                                    "scaled"])
def test_sketch_step_regimes_match_numpy(regime, composite, b):
    """JaxEngine (sketch_step + flush) equals NumpyEngine bit for bit on
    every stream regime, from classic (packed, rc) and from composite
    u32-plane input, on both selection paths. "cold" is one step into an
    empty state (every lane survives); "scaled" exercises the per-step
    below bound and the grow-and-redo rail."""
    rng = np.random.default_rng(zlib.crc32(f"{regime}{composite}{b}".encode()))
    if regime == "scaled":
        params = SketchParams.scaled(kmers_to_sketch=64, scale=0.002,
                                     kmer_length=21)
    else:
        params = SketchParams.mash(kmers_to_sketch=2000, final_size=2000,
                                   kmer_length=21)
    dev = JaxEngine(params, batch_size=b)
    host = NumpyEngine(params)
    cap0 = dev.capacity
    for pk, rc in _regime_batches(regime, b, rng):
        host.update(pk, rc)
        if composite:
            comp = (pk << np.uint64(1)) | rc.astype(np.uint64)
            dev.update((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (comp >> np.uint64(32)).astype(np.uint32))
        else:
            dev.update(pk, rc)
    if regime == "scaled":
        assert dev.capacity > cap0  # the grow rail fired
    for a, w in zip(dev.finalize_arrays(), host.finalize_arrays()):
        assert np.array_equal(np.asarray(a), np.asarray(w))
