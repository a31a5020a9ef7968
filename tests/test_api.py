"""Python API surface (mirrors python.rs behaviors)."""

import numpy as np
import pytest

import finch_tpu.api as finch
from finch_tpu.core.sketch import KmerCount, Sketch as CoreSketch
from finch_tpu.models.params import FilterParams, SketchParams


def mk(name, hashes, params=None, counts=None):
    params = params or SketchParams.mash(kmers_to_sketch=1000,
                                         final_size=1000, no_strict=True)
    kcs = [KmerCount(hash=h, kmer=b"A", count=(counts[i] if counts else 1),
                     extra_count=0) for i, h in enumerate(hashes)]
    core = CoreSketch(name=name, seq_length=10, num_valid_kmers=5,
                      comment="", hashes=kcs, filter_params=FilterParams(),
                      sketch_params=params)
    return finch.Sketch("", _core=core)


def test_sketch_file(query_fa_path):
    # filter=True with the hardwired absolute err_filter=1.0 (python.rs:670)
    # derives min-count 2 over the 10-hash sketch -> only the two count-2
    # kmers survive (the python API has no oversketch, python.rs:662-668)
    s = finch.sketch_file(query_fa_path, n_hashes=10, no_strict=True)
    assert len(s) == 2
    assert all(h[2] >= 2 for h in s.hashes)

    s = finch.sketch_file(query_fa_path, n_hashes=10, no_strict=True,
                          filter=False)
    assert len(s) == 10
    assert s.hashes[0][1] == b"ATGCTAGCTACGTAACGTCGC"
    assert s.sketch_params["kmer_length"] == 21
    assert s.name == query_fa_path


def test_merge_sum_counts():
    a = mk("a", [1, 3, 5])
    b = mk("b", [1, 4, 5])
    a.merge(b)
    assert [h[0] for h in a.hashes] == [1, 3, 4, 5]
    assert [h[2] for h in a.hashes] == [2, 1, 1, 2]
    assert a.seq_length == 20
    assert a.num_valid_kmers == 10


def test_merge_size_clip():
    a = mk("a", [1, 3, 5])
    b = mk("b", [2, 4, 6])
    a.merge(b, size=3)
    assert [h[0] for h in a.hashes] == [1, 2, 3]


def test_merge_incompatible():
    a = mk("a", [1])
    b = mk("b", [1], params=SketchParams.mash(kmer_length=31, no_strict=True))
    with pytest.raises(finch.FinchError, match="k 21"):
        a.merge(b)


def test_merge_scaled_clip():
    p = SketchParams.scaled(kmers_to_sketch=2, kmer_length=21, scale=1e-18)
    # max_hash = 18
    a = mk("a", [5, 10, 20, 30], params=p)
    b = mk("b", [6, 25], params=p)
    a.merge(b)  # size None + scale -> truncate to hash <= 18
    assert [h[0] for h in a.hashes] == [5, 6, 10]
    a2 = mk("a", [5, 10, 20, 30], params=p)
    a2.merge(mk("b", [6, 25], params=p), size=4)
    # take_while(hash <= max || ix < size)
    assert [h[0] for h in a2.hashes] == [5, 6, 10, 20]


def test_multisketch_container(tmp_path, query_fa_path):
    s1 = finch.sketch_file(query_fa_path, n_hashes=10, no_strict=True)
    ms = finch.Multisketch.from_sketches([s1])
    assert len(ms) == 1
    assert repr(ms) == "<Multisketch (1 sketch)>"
    assert query_fa_path in ms
    assert ms[0].name == query_fa_path
    assert ms[query_fa_path].name == query_fa_path
    ms.save(str(tmp_path / "m.bsk"))
    ms2 = finch.Multisketch.open(str(tmp_path / "m.bsk"))
    assert len(ms2) == 1
    assert ms2[0].hashes == s1.hashes
    del ms2[0]
    assert len(ms2) == 0
    with pytest.raises(KeyError):
        ms._index("nope")


def test_best_match_and_filter():
    db = finch.Multisketch.from_sketches(
        [mk("x", [1, 2, 3, 4]), mk("y", [1, 2, 5, 6]), mk("z", [7, 8])])
    q = mk("q", [1, 2, 5])
    ix, best = db.best_match(q)
    assert (ix, best.name) == (1, "y")
    db.filter_to_matches(q, threshold=0.5)
    assert [s.name for s in db.sketches] == ["x", "y"]
    db.filter_to_names(["y"])
    assert [s.name for s in db.sketches] == ["y"]


def test_compare():
    a = mk("a", [1, 2, 3])
    b = mk("b", [2, 3, 4])
    # raw_distance caps both sides at min(max_a, max_b)=3: i=2, j=3
    cont, jac = a.compare(b)
    assert jac == 2 / 3
    assert cont == 2 / 3


def test_compare_counts():
    ref = mk("r", [1, 2, 3], counts=[5, 6, 7])
    q = mk("q", [2, 3, 9], counts=[2, 4, 100])
    common, ref_pos, q_pos, ref_count, q_count, var, skew, kurt = \
        ref.compare_counts(q)
    assert common == 2
    assert ref_count == 6 + 7
    assert q_count == 2 + 4
    assert var == pytest.approx(1.0)  # counts 2,4 -> m2=2, var=1


def test_compare_matrix():
    ref = mk("r", [1, 2, 3])
    q1 = mk("q1", [2, 3], counts=[5, 9])
    mat = ref.compare_matrix(q1)
    np.testing.assert_array_equal(mat, [[0, 5, 9]])


def test_counts_setter_drops_zeros():
    s = mk("s", [1, 2, 3])
    s.counts = [5, 0, 7]
    assert [h[0] for h in s.hashes] == [1, 3]
    assert [h[2] for h in s.hashes] == [5, 7]
    with pytest.raises(finch.FinchError, match="Negative"):
        s.counts = [1, -2]
    with pytest.raises(finch.FinchError, match="same length"):
        s.counts = [1]


def test_copy_independent():
    s = mk("s", [1, 2])
    c = s.copy()
    c.name = "other"
    assert s.name == "s"


def test_metrics_meter_and_report(capsys):
    """utils.metrics: meters accumulate and report (SURVEY §5 observability)."""
    from finch_tpu.utils import get_meter, report

    m = get_meter("test_stage")
    with m.timed(100):
        pass
    m.start()
    m.stop(50)
    assert m.items >= 150 and m.calls >= 2 and m.rate() > 0
    import io
    buf = io.StringIO()
    report(file=buf)
    assert "test_stage" in buf.getvalue()


def test_distributed_global_mesh():
    """parallel.distributed.global_mesh covers all local (virtual) devices."""
    import jax

    from finch_tpu.parallel import distributed

    mesh = distributed.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("data",)
    assert distributed.is_primary() in (True, False)


def test_finch_dropin_shim(query_fa_path):
    """`import finch` works like the reference pyo3 module (python.rs:682)."""
    import finch

    s = finch.sketch_file(str(query_fa_path), n_hashes=10, filter=False)
    assert len(s.hashes) == 10
    ms = finch.Multisketch.from_sketches([s])
    assert len(ms) == 1 and isinstance(ms[0], finch.Sketch)


def test_multisketch_filter_to_names_and_save_roundtrip(tmp_path, query_fa_path):
    """python.rs:180-186 save (.bsk only) + filter_to_names semantics."""
    import finch_tpu.api as finch

    s1 = finch.sketch_file(str(query_fa_path), n_hashes=10, filter=False)
    s2 = s1.copy()
    s2.name = "other"
    ms = finch.Multisketch.from_sketches([s1, s2])
    ms.filter_to_names([s1.name])
    assert len(ms) == 1
    out = tmp_path / "db.bsk"
    ms.save(str(out))
    back = finch.Multisketch.open(str(out))
    assert len(back) == 1
    assert back[0].name == s1.name
    assert back[0].hashes == s1.hashes
    # like the reference, save writes finch (.bsk) format regardless of
    # the filename (python.rs:180-186 "TODO: support other file formats")
    ms.save(str(tmp_path / "db.msh"))
    from finch_tpu.serialization.finch_bsk import read_finch_file
    assert len(read_finch_file((tmp_path / "db.msh").read_bytes())) == 1


def test_multisketch_iteration_is_cow():
    """Accessing members defers the pyo3-style clone to first mutation:
    mutations through an accessed Sketch never reach the collection, and
    iterating a large DB does not deep-copy every member."""
    import time

    ms = _ms_with(["a", "b"])
    view = ms[0]
    view.name = "changed"
    assert ms[0].name == "a"          # collection untouched (python.rs:156)
    view2 = next(iter(ms))
    view2.counts = [0] * len(view2.counts)
    assert len(ms[0].counts) == len(_ms_with(["a"])[0].counts)

    # add() demotes the wrapper to a COW view (python.rs:196 clone-on-add)
    s = ms[1]
    ms.add(s)
    s.name = "mutated-after-add"
    assert ms[2].name == "b"

    # O(1) access: iterating many members must not scale with hash count
    big = _ms_with([f"s{i}" for i in range(50)])
    t0 = time.perf_counter()
    for _ in range(20):
        for item in big:
            pass
    assert time.perf_counter() - t0 < 1.0


def _ms_with(names):
    import finch_tpu.api as finch
    from finch_tpu.core.sketch import KmerCount, Sketch as CoreSketch
    from finch_tpu.models.params import FilterParams, SketchParams

    rng = np.random.default_rng(5)
    sketches = []
    for nm in names:
        hs = np.sort(rng.choice(2 ** 50, size=64, replace=False)
                     .astype(np.uint64))
        kcs = [KmerCount(hash=int(h), kmer=b"A" * 21, count=2,
                         extra_count=1) for h in hs]
        sketches.append(CoreSketch(
            name=nm, seq_length=10, num_valid_kmers=10, comment="",
            hashes=kcs, filter_params=FilterParams(),
            sketch_params=SketchParams.mash(kmers_to_sketch=64,
                                            final_size=64, no_strict=True)))
    return finch.Multisketch(sketches)


def test_compare_counts_closed_form_matches_streaming_loop():
    """The vectorized compare_counts must equal the reference's streaming
    walk exactly (incl. f64 moment rounding) on random sketches."""
    import finch_tpu.api as finch

    rng = np.random.default_rng(17)
    for trial in range(10):
        na, nb = rng.integers(1, 200, size=2)
        pool = rng.choice(2 ** 30, size=na + nb, replace=False)
        ha = np.sort(pool[:na].astype(np.uint64))
        # force overlap
        hb = np.sort(np.unique(np.concatenate(
            [pool[na:].astype(np.uint64),
             rng.choice(ha, size=min(na, 37), replace=False)])))
        a = _sk("a", ha, rng)
        b = _sk("b", hb, rng)
        got = a.compare_counts(b)
        want = _streaming_compare_counts(a.s.hashes, b.s.hashes)
        assert got == want, trial


def _sk(name, hashes, rng):
    import finch_tpu.api as finch
    from finch_tpu.core.sketch import KmerCount, Sketch as CoreSketch
    from finch_tpu.models.params import FilterParams, SketchParams

    kcs = [KmerCount(hash=int(h), kmer=b"C" * 21,
                     count=int(rng.integers(1, 50)),
                     extra_count=0) for h in hashes]
    core = CoreSketch(name=name, seq_length=0, num_valid_kmers=0,
                      comment="", hashes=kcs,
                      filter_params=FilterParams(),
                      sketch_params=SketchParams.mash(
                          kmers_to_sketch=len(kcs) or 1,
                          final_size=len(kcs) or 1, no_strict=True))
    return finch.Sketch("", _core=core)


def _streaming_compare_counts(reference, query):
    """Transcription of the original streaming loop (python.rs:496-559)
    kept as the oracle for the closed-form implementation."""
    import math

    common = ref_pos = ref_count = query_pos = query_count = 0
    q_mean = q_m2 = q_m3 = q_m4 = 0.0
    while ref_pos < len(reference) and query_pos < len(query):
        if reference[ref_pos].hash < query[query_pos].hash:
            ref_pos += 1
        elif query[query_pos].hash < reference[ref_pos].hash:
            query_pos += 1
        else:
            ref_count += reference[ref_pos].count
            query_count += query[query_pos].count
            n = common + 1.0
            fc = float(query[query_pos].count)
            delta = fc - q_mean
            delta_n = delta / n
            delta_n2 = delta_n * delta_n
            term1 = delta * delta_n * (n - 1.0)
            q_mean += delta_n
            q_m4 += (term1 * delta_n2 * (n * n - 3.0 * n + 3.0)
                     + 6.0 * delta_n2 * q_m2 - 4.0 * delta_n * q_m3)
            q_m3 += term1 * delta_n * (n - 2.0) - 3.0 * delta_n * q_m2
            q_m2 += term1
            ref_pos += 1
            query_pos += 1
            common += 1
    var = q_m2 / common if common else math.nan
    skew = (math.sqrt(common) * q_m3 / q_m2 ** 1.5) if q_m2 else math.nan
    kurt = (common * q_m4 / (q_m2 * q_m2) - 3.0) if q_m2 else math.nan
    return (common, ref_pos, query_pos, ref_count, query_count, var,
            skew, kurt)


def test_python_shim_sketch_file_arbitrary_k(query_fa_path):
    """python.rs sketch_file has no k bound (u8 via the CLI only); the
    compat shim must sketch at k >= 64 through the xwide path."""
    import finch

    s = finch.sketch_file(query_fa_path,
                          n_hashes=10, kmer_length=101, filter=False)
    assert len(s.hashes) == 10
    assert len(s.hashes[0][1]) == 101  # (hash, kmer, count, extra) tuples
