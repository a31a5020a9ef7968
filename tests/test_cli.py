"""Black-box CLI conformance (mirrors /root/reference/cli/tests/test_cli.rs)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERY_FA = os.path.join(REPO, "tests", "data", "query.fa")

GOLDEN_KMERS = [
    "ATGCTAGCTACGTAACGTCGC", "CAGTCGATCGATCGTAGCTGA",
    "CTCAGATGCTGAGCCGGTCTA", "GCTAGCTAGCATCGCTAGCTA",
    "GACTAGCTAGCTAGCTAGCGA", "CGCTAGCTACGATCGATCGAC",
    "TAATTTATACGGGCCTATTAA", "GCATCAGCTAGCATCGCTGTA",
    "AGCCGGTCTACTACTACACAT", "AAGGCCTAACTTAATAGGCCC",
]


def finch(*args, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["FINCH_TPU_PLATFORM"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "finch_tpu.cli", *args],
        capture_output=True, env=env)
    if check and proc.returncode != 0:
        raise AssertionError(
            f"finch {' '.join(args)} failed: {proc.stderr.decode()}")
    return proc


def test_file_doesnt_exist():
    """test_cli.rs:10-18. The unified FinchError surfaces as a clean
    "Error: ..." line (main.rs:194-199), never a Python traceback."""
    proc = finch("sketch", "test/file/doesnt/exist", check=False)
    assert proc.returncode != 0
    err = proc.stderr.decode()
    assert "No such file or directory" in err
    assert "Traceback" not in err


def test_old_dist_degenerate_sketch_emits_null(tmp_path):
    """--old-dist with an empty-hashes ref: Rust's 0/0 gives NaN which
    serde_json writes as null (distance.rs:150-155); no traceback."""
    full = tmp_path / "full.sk"
    empty = tmp_path / "empty.sk"
    head = ('{"kmer":21,"alphabet":"ACGT","preserveCase":false,'
            '"canonical":true,"sketchSize":4,'
            '"hashType":"MurmurHash3_x64_128","hashBits":64,"hashSeed":0,'
            '"scale":null,"sketches":[%s]}')
    sk = ('{"name":"%s","seqLength":0,"numValidKmers":0,"comment":"",'
          '"filters":{},"hashes":[%s],"kmers":[%s],"counts":[%s]}')
    full.write_text(head % (sk % ("q", '"1","2","3"',
                                  '"AAA","CCC","GGG"', "1,1,1")))
    empty.write_text(head % (sk % ("r", "", "", "")))
    proc = finch("dist", "--old-dist", str(full), str(empty), check=False)
    err = proc.stderr.decode()
    assert "Traceback" not in err
    assert proc.returncode == 0, err
    out = proc.stdout.decode()
    assert '"containment":null,"jaccard":null,"mashDistance":0.0' in out
    # reversed: empty query would panic in Rust; we error cleanly
    proc2 = finch("dist", "--old-dist", str(empty), str(full), check=False)
    err2 = proc2.stderr.decode()
    assert proc2.returncode != 0
    assert "Traceback" not in err2


def test_finch_sketch_stdout():
    """test_cli.rs:21-37."""
    proc = finch("sketch", "--n-hashes", "10", "-O", QUERY_FA)
    doc = json.loads(proc.stdout)
    assert doc["kmer"] == 21
    assert doc["alphabet"] == "ACGT"
    assert doc["sketchSize"] == 10
    assert doc["hashSeed"] == 0


def test_finch_sketch_bin_roundtrip(tmp_path):
    """test_cli.rs:40-57 (via -o file instead of stdout)."""
    out = tmp_path / "out"
    finch("sketch", "--n-hashes", "10", "-b", "-o", str(out), QUERY_FA)
    from finch_tpu.serialization.finch_bsk import read_finch_file
    data = (tmp_path / "out.bsk").read_bytes()
    sk = read_finch_file(data)
    assert len(sk) == 1
    assert sk[0].sketch_params.k == 21
    assert sk[0].sketch_params.expected_size() == 10
    assert len(sk[0].hashes) == 10


def test_finch_sketch_msh_roundtrip(tmp_path):
    """test_cli.rs:60-78."""
    out = tmp_path / "out"
    finch("sketch", "--n-hashes", "10", "-B", "-o", str(out), QUERY_FA)
    from finch_tpu.serialization.mash_msh import read_mash_file
    sk = read_mash_file((tmp_path / "out.msh").read_bytes())
    assert len(sk) == 1
    assert sk[0].sketch_params.k == 21
    assert len(sk[0].hashes) == 10


def test_finch_sketch_scaled_golden():
    """test_cli.rs:81-114."""
    proc = finch("sketch", "--n-hashes", "10", "--sketch-type", "scaled",
                 "--scale", ".001", QUERY_FA, "-O")
    doc = json.loads(proc.stdout)
    assert doc["kmer"] == 21
    assert doc["alphabet"] == "ACGT"
    assert doc["sketchSize"] == 10
    assert doc["sketches"][0]["kmers"] == GOLDEN_KMERS
    assert doc["hashSeed"] == 0


def test_finch_sketch_mash_golden():
    """test_cli.rs:117-149."""
    proc = finch("sketch", "--n-hashes", "10", "--sketch-type", "mash",
                 QUERY_FA, "-O")
    doc = json.loads(proc.stdout)
    assert doc["sketches"][0]["kmers"] == GOLDEN_KMERS


def test_sketch_in_place(tmp_path):
    """main.rs:201-235: sketch without -o/-O writes <input>.sk."""
    fa = tmp_path / "q.fa"
    shutil.copy(QUERY_FA, fa)
    finch("sketch", "--n-hashes", "10", str(fa))
    out = tmp_path / "q.fa.sk"
    assert out.exists()
    doc = json.loads(out.read_bytes())
    assert doc["sketchSize"] == 10
    # sketch files are rejected as sketch-in-place input
    proc = finch("sketch", str(out), check=False)
    assert proc.returncode != 0
    assert "is not a sequence file?" in proc.stderr.decode()


def test_dist_json(tmp_path):
    """dist between a sketch file and a FASTA, JSON output shape."""
    fa = tmp_path / "q.fa"
    shutil.copy(QUERY_FA, fa)
    finch("sketch", "--n-hashes", "10", str(fa))
    proc = finch("dist", str(tmp_path / "q.fa.sk"), QUERY_FA)
    dists = json.loads(proc.stdout)
    assert len(dists) == 1
    d = dists[0]
    assert list(d.keys()) == ["containment", "jaccard", "mashDistance",
                              "commonHashes", "totalHashes", "query",
                              "reference"]
    assert d["jaccard"] == 1.0
    assert d["mashDistance"] == 0.0
    assert d["commonHashes"] == 10
    # query name = the name recorded at sketch time (the original path)
    assert d["query"] == str(fa)
    assert d["reference"] == QUERY_FA


def test_dist_max_dist_filters(tmp_path):
    fa2 = tmp_path / "other.fa"
    fa2.write_bytes(b">o\n" + b"TTAGGCCATCAGGACCA" * 10 + b"\n")
    proc = finch("dist", "--n-hashes", "10", "-N", QUERY_FA, str(fa2),
                 "--max-dist", "0.5")
    dists = json.loads(proc.stdout)
    assert dists == []  # unrelated sequences exceed max-dist


def test_dist_pairwise_and_queries(tmp_path):
    fa2 = tmp_path / "other.fa"
    fa2.write_bytes(b">o\n" + b"TTAGGCCATCAGGACCA" * 10 + b"\n")
    proc = finch("dist", "-p", "--n-hashes", "10", "-N", QUERY_FA, str(fa2))
    dists = json.loads(proc.stdout)
    assert len(dists) == 2  # both directions, self-pairs skipped
    proc = finch("dist", "-q", str(fa2), "--n-hashes", "10", "-N", QUERY_FA,
                 str(fa2))
    dists = json.loads(proc.stdout)
    assert len(dists) == 1
    assert dists[0]["query"] == str(fa2)
    # both given: clap rejects the combination outright (cli.rs:71-85
    # conflicts_with — main.rs:92-107's pairwise-first branch is
    # unreachable in the reference binary)
    proc = finch("dist", "-p", "-q", str(fa2), "--n-hashes", "10", "-N",
                 QUERY_FA, str(fa2), check=False)
    assert proc.returncode != 0
    assert b"cannot be used with" in proc.stderr


def test_hist_json():
    proc = finch("hist", "--n-hashes", "10", QUERY_FA)
    doc = json.loads(proc.stdout)
    assert QUERY_FA in doc
    assert doc[QUERY_FA] == [8, 2]  # 8 kmers at depth 1, 2 at depth 2


def test_info_text():
    proc = finch("info", "--n-hashes", "10", QUERY_FA)
    out = proc.stdout.decode()
    assert out.startswith(QUERY_FA + " (from 405bp)")
    assert "Estimated # of Unique Kmers:" in out
    assert "Estimated Average Depth:" in out
    assert "Estimated % GC:" in out


def test_err_filter_limit():
    """cli.rs:264-265: err-filter limited to 100/k."""
    proc = finch("sketch", "--err-filter", "10", "-k", "21", "-O", QUERY_FA,
                 check=False)
    assert proc.returncode != 0
    assert "between 0 and" in proc.stderr.decode()


def test_conflicting_flags():
    proc = finch("sketch", "--sketch-type", "mash", "--scale", "0.1", "-O",
                 QUERY_FA, check=False)
    assert proc.returncode != 0
    assert "can not be specified for `mash`" in proc.stderr.decode()
    proc = finch("sketch", "--sketch-type", "scaled", "--oversketch", "10",
                 "-O", QUERY_FA, check=False)
    assert proc.returncode != 0
    proc = finch("sketch", "--filter", "--no-filter", "-O", QUERY_FA,
                 check=False)
    assert proc.returncode != 0


def test_param_inheritance_from_sketch_file(tmp_path):
    """main.rs:336-441: unset CLI args inherit from the first sketch file."""
    fa = tmp_path / "q.fa"
    shutil.copy(QUERY_FA, fa)
    finch("sketch", "--n-hashes", "7", "--seed", "5", str(fa))
    # dist with no explicit n/seed inherits 7/5 and sketches the FASTA
    # with the same params -> identical sketches
    proc = finch("dist", str(tmp_path / "q.fa.sk"), QUERY_FA)
    dists = json.loads(proc.stdout)
    assert dists[0]["commonHashes"] == 7
    assert dists[0]["jaccard"] == 1.0
    # mismatched explicit seed errors
    proc = finch("dist", "--seed", "9", str(tmp_path / "q.fa.sk"), QUERY_FA,
                 check=False)
    assert proc.returncode != 0
    assert "does not match" in proc.stderr.decode()


def test_full_workflow_chain(tmp_path):
    """sketch -> dist -> hist -> info over generated FASTQ files: the whole
    CLI surface chained as a user would run it."""
    import json
    import subprocess
    import sys

    import numpy as np

    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = []
    for fi in range(2):
        parts = []
        for i in range(300):
            L = int(rng.integers(40, 80))
            seq = bases[rng.integers(0, 4, size=L)].tobytes()
            parts.append(b"@r%d\n" % i + seq + b"\n+\n" + b"F" * L + b"\n")
        p = tmp_path / f"f{fi}.fastq"
        p.write_bytes(b"".join(parts))
        paths.append(str(p))

    def run(*args):
        return finch(*args).stdout.decode()

    # sketch in place -> .sk next to inputs
    run("sketch", "--n-hashes", "50", "--no-strict", *paths)
    sks = [p + ".sk" for p in paths]
    assert all(os.path.exists(s) for s in sks)

    # dist over the sketches
    dists = json.loads(run("dist", "--max-dist", "1.0", *sks))
    assert len(dists) == 1
    d = dists[0]
    assert set(d) == {"containment", "jaccard", "mashDistance",
                      "commonHashes", "totalHashes", "query", "reference"}

    # hist + info
    hist = json.loads(run("hist", sks[0]))
    assert list(hist) == [paths[0]]
    info = run("info", sks[0])
    assert "Estimated # of Unique Kmers" in info


def test_dist_pairwise_gram_float_parity(tmp_path):
    """dist --pairwise (Gram engine, vectorized f64) must byte-match the
    per-pair serial engine's JSON: same values, same ryu float text, same
    ref-major order (main.rs:315-334)."""
    import numpy as np

    rng = np.random.default_rng(6)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    base_seq = bases[rng.integers(0, 4, size=600)]
    for i in range(4):
        seq = base_seq.copy()
        # mutate a sliver so pairs share most hashes (non-trivial floats)
        pos = rng.integers(0, len(seq), size=10 + 30 * i)
        seq[pos] = bases[rng.integers(0, 4, size=len(pos))]
        f = tmp_path / f"g{i}.fa"
        f.write_bytes(b">g%d\n" % i + seq.tobytes() + b"\n")
        files.append(str(f))
    proc = finch("dist", "-p", "--n-hashes", "40", "-N", *files)
    got = json.loads(proc.stdout)

    # serial expectation through the library engine
    import finch_tpu as ft
    from finch_tpu.core.distance import distance

    params = ft.SketchParams.mash(kmers_to_sketch=40, final_size=40,
                                  no_strict=True)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)
    sketches = ft.sketch_files(files, params, filters, backend="numpy")
    want = []
    for ref in sketches:
        for q in sketches:
            if q == ref:
                continue
            d = distance(q, ref)
            want.append(d.to_json_dict())
    assert got == want
    assert any(0.0 < d["jaccard"] < 1.0 for d in got)


def test_dist_pairwise_survivors_duplicate_name_skip(tmp_path):
    """The device-survivors path must apply the struct-equality self-skip
    (main.rs:322): a sketch present twice under the same name emits no
    pair with itself, byte-identical to the serial engine."""
    import json

    import numpy as np

    from finch_tpu import cli
    from finch_tpu.core.distance import distance
    from finch_tpu.core.sketch import LazyKmerCounts, Sketch
    from finch_tpu.models.params import FilterParams, SketchParams
    from finch_tpu.serialization.finch_bsk import write_finch_file

    rng = np.random.default_rng(12)
    p = SketchParams.mash(kmers_to_sketch=30, final_size=30,
                          no_strict=True)
    pool = rng.choice(1 << 48, size=90, replace=False).astype(np.uint64)

    def mk(nm, seed):
        r = np.random.default_rng(seed)
        hs = np.sort(r.choice(pool, size=30, replace=False))
        c = r.integers(1, 4, size=30, dtype=np.uint32)
        return Sketch(name=nm, seq_length=9, num_valid_kmers=12,
                      comment="",
                      hashes=LazyKmerCounts(hs, [b""] * 30, c, c // 2),
                      filter_params=FilterParams(filter_on=False),
                      sketch_params=p)

    sks = [mk("a", 1), mk("b", 2), mk("a", 1), mk("b", 9)]
    # sks[0] == sks[2] (same name, same content): skipped both ways;
    # sks[1] vs sks[3] share a name but differ: NOT skipped
    db = tmp_path / "d.bsk"
    db.write_bytes(write_finch_file(sks))
    out = tmp_path / "o.json"
    cli.run(["dist", "--pairwise", "--max-dist", "0.9", str(db),
             "-o", str(out)])
    rows = json.load(open(out))

    want = []
    for ref in sks:
        for q in sks:
            if q == ref:
                continue
            d = distance(q, ref)
            if d.mash_distance <= 0.9:
                want.append(d.to_json_dict())
    assert rows == want
    assert any(r["query"] == "b" and r["reference"] == "b" for r in rows)


def test_std_out_conflicts_with_output_file(tmp_path):
    """clap: std_out.conflicts_with("output_file") (cli.rs:200-215) —
    both flags together must error, not silently pick one."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "finch_tpu.cli", "sketch", "-N", "-O",
         "-o", str(tmp_path / "x"), QUERY_FA],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    assert proc.returncode != 0
    assert "cannot be used with" in proc.stderr
