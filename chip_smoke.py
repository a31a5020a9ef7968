"""Smoke test of finch_tpu on one NVIDIA GPU, in one process.

    python chip_smoke.py [--seed N] [--four-cards]

Drives the main paths through the user entry points at a size users run,
and checks every result exactly against the repository's host oracles:

  1. read-set sketch: a seeded ~1 GB FASTQ (3.3M reads x 150 bp from a
     random 5 Mbp genome, 1% substitutions, random strand) through
     `finch sketch --n-hashes 10000 --backend auto` (in-process CLI);
     the device engine must have run, and the .sk bytes must equal
     `--backend native` (the fused C++ host fold);
  2. the device sketch step at bench width (k=21, 4M batch, 200k cap)
     on uniform, tiled dup64 and shuffled dup64 streams, state equal to
     NativeEngine after 16 steps; times one warm step, the hash +
     prefilter pass alone and a device copy of the same bytes;
  3. scaled (scale 0.001, k=31) over the phase-1 FASTQ under `auto`,
     with the grow-and-redo rail firing on the device, and k=51
     (n 100000, unfiltered, so every retained count is compared) on
     `--backend jax` over a 100 MB slice, both equal to `--backend numpy`;
  4. distance over 10,000 clustered sketches x 1,000 hashes: int8 and
     bf16 Gram equal, Gram stats equal to core/distance.py on sampled
     pairs, and `finch dist` (pairwise and queries vs refs) byte-equal
     to `--backend numpy` on a 400-sketch subset.

--four-cards runs only the multi-device paths and what they are compared
with: the phase-1 sketch under `auto` over every device
(ShardedSketchEngine) against the one-device engine, sharded_common
against all_pairs_common, and the mesh tile engine against the unsharded
one. The last line is the JSON verdict; the script exits non-zero, with
no verdict, when JAX finds no GPU or anything differs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = {
    "reads": 3_300_000, "read_len": 150, "genome": 5_000_000,
    "n_hashes": 10_000, "scale": 0.001, "wide_bytes": 100 << 20,
    "batch": 1 << 22, "cap": 200_000, "steps": 16,
    "dist_n": 10_000, "dist_k": 1_000, "dist_sub": 400, "pairs": 10_000,
}


def log(**fields) -> None:
    print(json.dumps(fields, default=str), flush=True)


def device_peak() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def run_cli(*argv: str) -> None:
    """`finch <argv>` in this process (no JAX child process)."""
    from finch_tpu import cli

    cli.run(list(argv))


@contextlib.contextmanager
def record_engines():
    """Collect every sketching engine the CLI creates."""
    from finch_tpu.core import sketching

    made = []
    orig = sketching.make_engine

    def recording(*a, **kw):
        eng = orig(*a, **kw)
        made.append(eng)
        return eng

    sketching.make_engine = recording
    try:
        yield made
    finally:
        sketching.make_engine = orig


@contextlib.contextmanager
def count_grows():
    """Count calls of the device state's grow-and-redo rail."""
    from finch_tpu.ops import bottomk

    calls = []
    orig = bottomk.grow_state

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    bottomk.grow_state = counting
    try:
        yield calls
    finally:
        bottomk.grow_state = orig


def write_fastq(path: str, rng, reads: int, read_len: int,
                genome: int, chunk: int = 200_000) -> int:
    """Seeded FASTQ of reads drawn from one random genome, with 1%
    substitutions and a random strand. Fixed-width records; returns the
    record length in bytes."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, size=genome, dtype=np.uint8)
    rec_len = 1 + 9 + 1 + read_len + 3 + read_len + 1
    pow10 = 10 ** np.arange(8, -1, -1, dtype=np.int64)
    with open(path, "wb") as f:
        for start in range(0, reads, chunk):
            m = min(chunk, reads - start)
            pos = rng.integers(0, genome - read_len + 1, size=m)
            seq = g[pos[:, None] + np.arange(read_len)]
            sub = rng.random((m, read_len)) < 0.01
            shift = rng.integers(1, 4, size=(m, read_len), dtype=np.uint8)
            seq = np.where(sub, (seq + shift) % 4, seq).astype(np.uint8)
            rev = rng.random(m) < 0.5
            seq[rev] = 3 - seq[rev, ::-1]
            rec = np.empty((m, rec_len), dtype=np.uint8)
            rec[:, 0] = ord("@")
            ids = start + np.arange(m, dtype=np.int64)
            rec[:, 1:10] = (ids[:, None] // pow10) % 10 + ord("0")
            rec[:, 10] = ord("\n")
            rec[:, 11:11 + read_len] = acgt[seq]
            rec[:, 11 + read_len:14 + read_len] = np.frombuffer(
                b"\n+\n", dtype=np.uint8)
            rec[:, 14 + read_len:14 + 2 * read_len] = ord("I")
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())
    return rec_len


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _on_gpu(arr) -> bool:
    return {d.platform for d in arr.devices()} == {"gpu"}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_read_set(work: str, fastq: str, n_hashes: int,
                   dev_backend: str = "auto",
                   require_gpu: bool = True) -> dict:
    """Phase 1: CLI sketch of the read set on the device vs the fused
    host fold; byte-equal .sk files."""
    from finch_tpu.models.engine import HybridEngine, JaxEngine

    out_dev = os.path.join(work, "reads_dev.sk")
    out_host = os.path.join(work, "reads_native.sk")
    t0 = time.perf_counter()
    with record_engines() as made:
        run_cli("sketch", "--n-hashes", str(n_hashes), "--backend",
                dev_backend, "-o", out_dev, fastq)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli("sketch", "--n-hashes", str(n_hashes), "--backend", "native",
            "-o", out_host, fastq)
    t_host = time.perf_counter() - t0
    (eng,) = made
    dev = eng._dev if isinstance(eng, HybridEngine) else eng
    assert isinstance(dev, JaxEngine), f"no device engine ran: {eng!r}"
    if require_gpu:
        assert all(_on_gpu(x) for x in dev.state), "state not on the GPU"
    a, b = _read(out_dev), _read(out_host)
    assert a == b, "device .sk differs from --backend native"
    n = len(json.loads(a)["sketches"][0]["hashes"])
    return {"phase": "1_read_set", "engine": type(eng).__name__,
            "capacity": dev.capacity, "sk_bytes": len(a), "hashes": n,
            "wall_s_device": t_dev, "wall_s_native": t_host,
            "peak_bytes_in_use": device_peak()}


def _timed(fn, *args, reps: int = 10) -> float:
    """Median seconds of fn(*args) with block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_step(rng, batch: int, cap: int, steps: int, k: int = 21) -> list:
    """Phase 2: the jitted sketch step at bench width on three streams,
    flushed state equal to NativeEngine over the same k-mers."""
    import jax
    import jax.numpy as jnp

    from finch_tpu.models.engine import NativeEngine
    from finch_tpu.models.params import SketchParams
    from finch_tpu.ops import bottomk

    pool = rng.integers(0, 4 ** k, size=batch, dtype=np.uint64)
    rc = rng.integers(0, 2, size=batch, dtype=np.uint8)
    tiled = (np.tile(pool[: batch // 64], 64), np.tile(rc[: batch // 64], 64))
    perm = rng.permutation(batch)
    streams = {"uniform": (pool, rc), "tiled_dup64": tiled,
               "shuffled_dup64": (tiled[0][perm], tiled[1][perm])}
    nv = jnp.uint32(batch)
    mh = jnp.uint64(0)
    statics = dict(k=k, seed=0, has_max_hash=False, composite=False,
                   xla_aggregate=False, spill_compact=bottomk.SPILL_COMPACT)

    t0 = time.perf_counter()
    step = bottomk._sketch_step.lower(
        bottomk.empty_state(cap), jnp.asarray(pool), jnp.asarray(rc), nv,
        mh, **statics).compile()
    compile_s = time.perf_counter() - t0
    out = [{"phase": "2_step_compile", "compile_s": compile_s,
            "memory_analysis": str(step.memory_analysis())}]

    params = SketchParams.mash(kmers_to_sketch=cap, final_size=1000,
                               kmer_length=k)
    kmask = np.uint64(4 ** k - 1)
    hp = jax.jit(bottomk._hash_prefilter, static_argnames=("k", "seed"))
    for name, (spk, src) in streams.items():
        state = bottomk.empty_state(cap)
        host = NativeEngine(params)
        rc_d = jnp.asarray(src)
        step_s = []
        for i in range(steps):
            # fresh k-mers every step; xor keeps in-batch duplicates
            pk = spk ^ (np.uint64(i * 0x9E3779B97F4A7C15 % (1 << 64))
                        & kmask)
            host.update(pk, src)
            pk_d = jax.block_until_ready(jnp.asarray(pk))
            t0 = time.perf_counter()
            state, _ = step(state, pk_d, rc_d, nv, mh)
            jax.block_until_ready(state)
            step_s.append(time.perf_counter() - t0)
        flushed, _ = bottomk.flush_state(state, mh, k=k, seed=0)
        got = [np.asarray(x) for x in flushed[:4]]
        want = host.state_arrays()
        n = len(want[0])
        for g, w in zip(got, want):
            assert np.array_equal(g[:n], w), f"{name}: state != NativeEngine"
        assert np.all(got[0][n:] == bottomk.U64_MAX), f"{name}: extra hashes"

        thresh = state[0][-1]
        valid = jnp.ones((batch,), bool)
        t_hash = _timed(lambda a, b: hp(a, b, valid, thresh, k=k, seed=0),
                        pk_d, rc_d)
        t_copy = _timed(jax.jit(lambda a, b: (jnp.copy(a), jnp.copy(b))),
                        pk_d, rc_d)
        warm = step_s[1:]
        out.append({
            "phase": "2_step", "stream": name, "batch": batch, "cap": cap,
            "steps": steps, "warm_step_s_median": float(np.median(warm)),
            "warm_step_s_min": float(np.min(warm)),
            "kmers_per_s": batch / float(np.median(warm)),
            "hash_prefilter_s": t_hash, "copy_s": t_copy,
            "copy_bytes": 2 * (pk_d.nbytes + rc_d.nbytes),
            "peak_bytes_in_use": device_peak()})
    return out


def phase_scaled_wide(work: str, fastq: str, rec_len: int, scale: float,
                      wide_bytes: int, dev_backend: str = "auto") -> list:
    """Phase 3: scaled k=31 under `auto` (grow rail on the device) and
    k=51 on the device engine over a slice, both equal to numpy."""
    out = []
    paths = {}
    for backend in (dev_backend, "numpy"):
        paths[backend] = os.path.join(work, f"scaled_{backend}.sk")
        t0 = time.perf_counter()
        with count_grows() as grows:
            run_cli("sketch", "-s", "scaled", "--scale", str(scale), "-k",
                    "31", "--backend", backend, "-o", paths[backend], fastq)
        out.append({"phase": "3_scaled", "backend": backend,
                    "grows": len(grows),
                    "wall_s": time.perf_counter() - t0})
        if backend == dev_backend:
            assert grows, "the grow-and-redo rail never fired"
    a = _read(paths[dev_backend])
    assert a == _read(paths["numpy"]), "scaled sketch differs from numpy"
    out[0]["hashes"] = len(json.loads(a)["sketches"][0]["hashes"])

    wide_fq = os.path.join(work, "slice.fq")
    n_rec = max(1, wide_bytes // rec_len)
    with open(fastq, "rb") as src, open(wide_fq, "wb") as dst:
        dst.write(src.read(n_rec * rec_len))
    for backend in ("jax", "numpy"):
        paths[backend] = os.path.join(work, f"k51_{backend}.sk")
        t0 = time.perf_counter()
        run_cli("sketch", "-k", "51", "--n-hashes", "100000", "-N",
                "--no-filter", "--backend", backend, "-o", paths[backend],
                wide_fq)
        out.append({"phase": "3_k51", "backend": backend,
                    "slice_bytes": n_rec * rec_len,
                    "wall_s": time.perf_counter() - t0})
    assert _read(paths["jax"]) == _read(paths["numpy"]), \
        "k=51 sketch differs from numpy"
    out[-1]["hashes"] = len(json.loads(_read(paths["jax"]))["sketches"][0]
                            ["hashes"])
    out[-1]["peak_bytes_in_use"] = device_peak()
    return out


def clustered_db(rng, n: int, k: int):
    """The benchmarks/bench_dist10k.py generator: 100 clusters whose
    members share ~20% of their hashes (or n // 100 clusters at small n)."""
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    try:
        from bench_dist10k import clustered_db as gen
    finally:
        sys.path.pop(0)
    return gen(rng, n, k, n_clusters=min(100, max(1, n // 100)))


def _dot_operand_dtypes(fn, *args) -> set:
    """dtypes of every dot_general operand in fn's jaxpr (recursively)."""
    import jax

    found = set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.update(str(v.aval.dtype) for v in eqn.invars)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def write_db(path: str, H: np.ndarray) -> list:
    """Write rows of H as a .bsk sketch DB; returns the sketch names."""
    from finch_tpu.core.sketch import LazyKmerCounts, Sketch
    from finch_tpu.models.params import FilterParams, SketchParams
    from finch_tpu.serialization.finch_bsk import write_finch_file

    n, k = H.shape
    params = SketchParams.mash(kmers_to_sketch=k, final_size=k,
                               no_strict=True)
    counts = np.ones(k, dtype=np.uint32)
    names = [f"s{i:05d}" for i in range(n)]
    sketches = [Sketch(name=nm, seq_length=k * 30, num_valid_kmers=k * 20,
                       comment="",
                       hashes=LazyKmerCounts(H[i], [b""] * k, counts,
                                             counts - 1),
                       filter_params=FilterParams(filter_on=False),
                       sketch_params=params)
                for i, nm in enumerate(names)]
    with open(path, "wb") as f:
        f.write(write_finch_file(sketches))
    return names


def phase_dist(work: str, rng, H: np.ndarray, sub: int, pairs: int) -> list:
    """Phase 4: Gram engine (int8 and bf16) vs each other and vs
    core/distance.py; `finch dist` byte-equal to --backend numpy."""
    import jax
    import jax.numpy as jnp

    from finch_tpu.core.distance import raw_distance_arrays
    from finch_tpu.parallel import mxu_dist

    n, k = H.shape
    lengths = np.full(n, k, dtype=np.int32)
    flat_h = jnp.asarray(H.reshape(-1))
    flat_s = jnp.asarray(np.repeat(np.arange(n, dtype=np.int32), k))
    cap = n * k
    page = mxu_dist._page_size(2048, n, cap)
    rid, sid, n_shared, _ = mxu_dist._shared_incidences(flat_h, flat_s, cap)
    out = []
    for int8 in (True, False):
        dtypes = _dot_operand_dtypes(
            lambda r, s, m: mxu_dist._gram_accumulate(r, s, m, n, page,
                                                      int8=int8),
            rid, sid, n_shared)
        assert dtypes and "float32" not in dtypes, dtypes
        t0 = time.perf_counter()
        jax.block_until_ready(mxu_dist._gram_accumulate(
            rid, sid, n_shared, n, page, int8=int8))
        first = time.perf_counter() - t0
        t = _timed(lambda r, s, m: mxu_dist._gram_accumulate(
            r, s, m, n, page, int8=int8), rid, sid, n_shared, reps=3)
        out.append({"phase": "4_gram", "int8": int8, "n": n, "k": k,
                    "dot_operand_dtypes": sorted(dtypes),
                    "first_call_s": first, "gram_s": t,
                    "n_shared": int(n_shared)})

    stats = {}
    saved = mxu_dist.GRAM_INT8
    try:
        for int8 in (True, False):
            mxu_dist.GRAM_INT8 = int8
            t0 = time.perf_counter()
            stats[int8] = mxu_dist.all_pairs_stats(H, lengths)
            out.append({"phase": "4_all_pairs_stats", "int8": int8,
                        "wall_s": time.perf_counter() - t0})
    finally:
        mxu_dist.GRAM_INT8 = saved
    for a, b in zip(stats[True], stats[False]):
        assert np.array_equal(a, b), "int8 and bf16 Gram stats differ"
    common, i_m, j_m = stats[True]
    qs = rng.integers(0, n, size=pairs)
    rs = rng.integers(0, n, size=pairs)
    for q, r in zip(qs, rs):
        cont, jac, c, total = raw_distance_arrays(H[q], H[r], 0.0)
        ii, jj = int(i_m[q, r]), int(j_m[q, r])
        assert (c, total) == (int(common[q, r]), ii - c + jj), (q, r)
        assert cont == (0.0 if jj == 0 else c / jj), (q, r)
    out.append({"phase": "4_sampled_pairs", "pairs": pairs,
                "max_common": int(common[~np.eye(n, dtype=bool)].max()),
                "peak_bytes_in_use": device_peak()})

    db = os.path.join(work, "db.bsk")
    names = write_db(db, H[:sub])
    queries = names[:16]
    runs = {"pairwise": ["--pairwise"],
            "pairwise_max_dist": ["--pairwise", "--max-dist", "0.2"],
            "queries": ["--queries", *queries]}
    for label, flags in runs.items():
        res = {}
        for backend in ("auto", "numpy"):
            path = os.path.join(work, f"dist_{label}_{backend}.json")
            t0 = time.perf_counter()
            run_cli("dist", *flags, "--backend", backend, "-o", path, db)
            res[backend] = (_read(path), time.perf_counter() - t0)
        assert res["auto"][0] == res["numpy"][0], f"dist {label} differs"
        out.append({"phase": "4_cli_dist", "run": label, "sketches": sub,
                    "rows": len(json.loads(res["auto"][0])),
                    "wall_s_device": res["auto"][1],
                    "wall_s_numpy": res["numpy"][1]})
    return out


def phase_four_cards(work: str, fastq: str, n_hashes: int, H: np.ndarray,
                     dev_backend: str = "auto") -> list:
    """--four-cards: the sharded sketch, sharded Gram and mesh tile
    engine, each against its one-device counterpart."""
    import jax

    from finch_tpu.parallel import ShardedSketchEngine, make_mesh
    from finch_tpu.parallel.mxu_dist import all_pairs_common, sharded_common
    from finch_tpu.parallel.sharded_dist import all_vs_all_arrays

    out = []
    paths = {}
    for backend in (dev_backend, "jax"):
        paths[backend] = os.path.join(work, f"reads4_{backend}.sk")
        t0 = time.perf_counter()
        with record_engines() as made:
            run_cli("sketch", "--n-hashes", str(n_hashes), "--backend",
                    backend, "-o", paths[backend], fastq)
        out.append({"phase": "5_sketch", "backend": backend,
                    "engine": type(made[0]).__name__,
                    "wall_s": time.perf_counter() - t0})
        if backend == dev_backend:
            assert isinstance(made[0], ShardedSketchEngine), made
            assert made[0].n == len(jax.devices())
    assert _read(paths[dev_backend]) == _read(paths["jax"]), \
        "sharded sketch differs from the one-device sketch"

    n, k = H.shape
    lengths = np.full(n, k, dtype=np.int32)
    mesh = make_mesh()
    t0 = time.perf_counter()
    got = sharded_common(H, lengths, mesh)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = all_pairs_common(H, lengths)
    t_one = time.perf_counter() - t0
    assert np.array_equal(got, want), "sharded_common != all_pairs_common"
    out.append({"phase": "5_gram", "n": n, "k": k, "wall_s_sharded": t_sh,
                "wall_s_one_device": t_one})

    qs = [H[i] for i in range(0, n, max(1, n // 64))][:64]
    rs = [H[i] for i in range(n)]
    t0 = time.perf_counter()
    a = all_vs_all_arrays(qs, rs, mesh=mesh)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = all_vs_all_arrays(qs, rs)
    t_one = time.perf_counter() - t0
    for x, y in zip(a, b):
        assert np.array_equal(x, y), "mesh tile engine != one device"
    out.append({"phase": "5_tile", "queries": len(qs), "refs": len(rs),
                "wall_s_sharded": t_sh, "wall_s_one_device": t_one,
                "peak_bytes_in_use": device_peak()})
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths (4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    import finch_tpu  # noqa: F401  (x64, compile cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    if args.four_cards and len(jax.devices()) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    log(jax=jax.__version__, platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), seed=args.seed,
        compile_cache=jax.config.jax_compilation_cache_dir)

    s = FULL
    rng = np.random.default_rng(args.seed)
    work = os.path.join(HERE, ".scratch", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        fastq = os.path.join(work, "reads.fq")
        t0 = time.perf_counter()
        rec_len = write_fastq(fastq, rng, s["reads"], s["read_len"],
                              s["genome"])
        log(phase="0_data", fastq_bytes=os.path.getsize(fastq),
            setup_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        H = clustered_db(rng, s["dist_n"], s["dist_k"])
        log(phase="0_data", db=list(H.shape),
            setup_s=time.perf_counter() - t0)
        if args.four_cards:
            phases = [lambda: phase_four_cards(work, fastq, s["n_hashes"],
                                               H)]
        else:
            phases = [
                lambda: [phase_read_set(work, fastq, s["n_hashes"])],
                lambda: phase_step(rng, s["batch"], s["cap"], s["steps"]),
                lambda: phase_scaled_wide(work, fastq, rec_len, s["scale"],
                                          s["wide_bytes"]),
                lambda: phase_dist(work, rng, H, s["dist_sub"], s["pairs"]),
            ]
        for phase in phases:
            for r in phase():
                log(**r)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
