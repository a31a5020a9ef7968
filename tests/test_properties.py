"""Property-based tests (hypothesis) mirroring the reference's proptest
strategy (lib/src/distance.rs:176-185, scaled.rs:202-213) plus the batch-
equivalence theorem that underpins the device engines."""

import numpy as np
from hypothesis import given, settings, strategies as st

from finch_tpu.core.distance import raw_distance_arrays
from finch_tpu.models.engine import NumpyEngine
from finch_tpu.models.oracle import OracleMashSketcher
from finch_tpu.models.params import SketchParams

sorted_hashes = st.lists(
    st.integers(min_value=0, max_value=2 ** 64 - 2),
    min_size=0, max_size=50, unique=True,
).map(lambda xs: np.sort(np.array(xs, dtype=np.uint64)))


@settings(max_examples=50, deadline=None)
@given(sorted_hashes, sorted_hashes)
def test_raw_distance_jaccard_commutative(a, b):
    """distance.rs:176-185: jaccard(a, b) == jaccard(b, a)."""
    _, jab, cab, tab = raw_distance_arrays(a, b, 0.0)
    _, jba, cba, tba = raw_distance_arrays(b, a, 0.0)
    assert jab == jba and cab == cba and tab == tba


@settings(max_examples=25, deadline=None)
@given(st.text(alphabet="ACGT", min_size=30, max_size=200),
       st.floats(min_value=0.01, max_value=1.0))
def test_scaled_retains_only_below_max_hash(seq, scale):
    """scaled.rs:202-213: with size=0 every retained hash <= max_hash."""
    from finch_tpu.native import KmerReader

    params = SketchParams.scaled(scale=scale, kmers_to_sketch=0,
                                 kmer_length=21)
    eng = NumpyEngine(params)
    data = b">r\n" + seq.encode() + b"\n"
    for packed, rc in KmerReader(data, k=21, batch_size=1024):
        eng.update(packed, rc)
    max_hash = params.max_hash()
    for kc in eng.finalize():
        assert kc.hash <= max_hash


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=4 ** 21 - 1),
                min_size=1, max_size=300),
       st.randoms(use_true_random=False))
def test_batch_equivalence_any_partition(kmers, rng):
    """The batch-equivalence theorem: any batch partition of the stream
    produces the identical sketch (counts included) as one-at-a-time
    streaming through the heap-faithful oracle."""
    from finch_tpu.native import unpack_kmers

    params = SketchParams.mash(kmers_to_sketch=16, final_size=16)
    pk = np.array(kmers, dtype=np.uint64)
    rc = np.array([rng.randint(0, 1) for _ in kmers], dtype=np.uint8)

    oracle = OracleMashSketcher(16, 21, 0)
    kmer_bytes = unpack_kmers(pk, 21)
    for kb, r in zip(kmer_bytes, rc):
        oracle.push(bytes(kb), int(r))

    eng = NumpyEngine(params)
    i = 0
    while i < len(pk):
        step = rng.randint(1, len(pk) - i)
        eng.update(pk[i:i + step], rc[i:i + step])
        i += step

    a = [(h, c, e) for (h, _km, c, e) in oracle.to_vec()]
    b = [(k.hash, k.count, k.extra_count) for k in eng.finalize()]
    assert a == b


def test_fused_pipeline_fuzz_vs_oracle(tmp_path):
    """Hypothesis fuzz: random FASTA/FASTQ content through the fused C++
    parse+fold pipeline equals the NumpyEngine oracle path."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from finch_tpu.core.sketching import sketch_stream
    from finch_tpu.models.params import FilterParams, SketchParams

    @settings(max_examples=20, deadline=None)
    @given(
        st.lists(st.text(alphabet="ACGTNacgtn", min_size=1, max_size=200),
                 min_size=1, max_size=12),
        st.booleans(),
        st.integers(2, 40),
    )
    def check(seqs, fastq, size):
        if fastq:
            data = b"".join(
                b"@r%d\n%s\n+\n%s\n" % (i, s.encode(), b"I" * len(s))
                for i, s in enumerate(seqs))
        else:
            data = b"".join(
                b">r%d\n%s\n" % (i, s.encode())
                for i, s in enumerate(seqs))
        path = tmp_path / "fuzz.fx"
        path.write_bytes(data)
        params = SketchParams.mash(kmers_to_sketch=size, final_size=size,
                                   no_strict=True)
        fused = sketch_stream(str(path), "x", params,
                              FilterParams(filter_on=False),
                              backend="native", parser_threads=3)
        ref = sketch_stream(str(path), "x", params,
                            FilterParams(filter_on=False),
                            backend="numpy", parser_threads=1)
        assert [(k.hash, k.kmer, k.count, k.extra_count)
                for k in fused.hashes] == \
               [(k.hash, k.kmer, k.count, k.extra_count)
                for k in ref.hashes]
        assert (fused.seq_length, fused.num_valid_kmers) == \
               (ref.seq_length, ref.num_valid_kmers)

    check()


def test_compact_spill_fuzz_vs_dict_model():
    """_compact_spill vs a Python dict model: arbitrary weighted entries,
    duplicates, and interspersed U64_MAX holes must compact to exactly
    the model's (composite -> total count) map (ops/bottomk.py)."""
    import jax.numpy as jnp

    from finch_tpu.ops import bottomk

    U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

    @settings(max_examples=40, deadline=None)
    @given(
        st.integers(1, 25),                 # k (weight field >= 12 bits)
        st.lists(st.tuples(st.integers(0, 200), st.integers(1, 300)),
                 min_size=0, max_size=120),  # (composite index, count)
        st.randoms(use_true_random=False),
    )
    def check(k, items, rng):
        s = bottomk._spill_weight_shift(k)
        if not bottomk._compact_worthwhile(k):
            return
        size = 256
        spill = np.full(size, U64_MAX, dtype=np.uint64)
        model = {}
        slots = list(range(size))
        rng.shuffle(slots)
        it = iter(slots)
        for ci, count in items[: size]:
            # composite+1 encoding, bounded by the 2k+2-bit field
            comp = np.uint64(ci % ((1 << (2 * k + 1)) - 1) + 1)
            spill[next(it)] = comp + (np.uint64(count - 1) << np.uint64(s))
            model[int(comp)] = model.get(int(comp), 0) + count
        out, n_real, ovf = bottomk._compact_spill(jnp.asarray(spill), k=k)
        out = np.asarray(out)
        width = 64 - s
        expect_ovf = any(v - 1 >= (1 << width) for v in model.values())
        assert bool(ovf) == expect_ovf
        if expect_ovf:
            return
        assert int(n_real) == len(model)
        got = out[: int(n_real)]
        assert np.all(out[int(n_real):] == U64_MAX)
        mask = np.uint64((1 << s) - 1)
        got_map = {int(g & mask): int(g >> np.uint64(s)) + 1 for g in got}
        assert got_map == model
        # ascending composite order at the front
        assert np.array_equal(got & mask, np.sort(got & mask))

    check()
