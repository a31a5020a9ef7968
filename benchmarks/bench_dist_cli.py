"""End-to-end `finch dist --pairwise` benchmark through the user
entrypoint: DB load -> Gram engine -> JSON encode ->
file write, timed as one CLI invocation — the figure a user actually
sees, unlike bench_dist10k.py's engine-phase numbers.

Builds (once, cached under .scratch/) a clustered .bsk DB like bench_dist10k.py's
(100-sketch clusters sharing ~20% of hashes: within-cluster mash ~0.077,
cross-cluster ~1.0), runs

    finch dist --pairwise --max-dist 0.1 db.bsk -o out.json

via cli.run() in-process, and reports wall-clock pairs/s over the full
N^2 pair space plus the phase split. Reference behavior:
/root/reference/cli/src/main.rs:315-334 (serial per-pair loop).

    python benchmarks/bench_dist_cli.py [--n 10000] [--k 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_db(path: str, n: int, k: int, n_clusters: int = 100,
             share: float = 0.4) -> None:
    from finch_tpu.core.sketch import LazyKmerCounts, Sketch
    from finch_tpu.models.params import FilterParams, SketchParams
    from finch_tpu.serialization.finch_bsk import write_finch_file

    rng = np.random.default_rng(17)
    params = SketchParams.mash(kmers_to_sketch=k, final_size=k,
                               no_strict=True)
    per = max(1, n // n_clusters)
    n_shared = int(k * share)
    sketches = []
    for i in range(n):
        c = i // per
        pool_rng = np.random.default_rng(1000 + c)
        # pool of k: expected within-cluster common = share^2*k, so
        # jaccard ~ share^2/(2-share^2) = 0.087 at share 0.4 -> mash
        # ~0.087, inside the --max-dist 0.1 cut; cross-cluster ~0
        pool = pool_rng.choice(1 << 62, size=k,
                               replace=False).astype(np.uint64)
        own = rng.choice(1 << 62, size=k - n_shared,
                         replace=False).astype(np.uint64)
        hs = np.sort(np.concatenate(
            [rng.choice(pool, size=n_shared, replace=False), own]))
        counts = rng.integers(1, 5, size=k, dtype=np.uint32)
        sketches.append(Sketch(
            name=f"s{i:05d}", seq_length=k * 30, num_valid_kmers=k * 20,
            comment="",
            hashes=LazyKmerCounts(hs, [b""] * k, counts, counts // 2),
            filter_params=FilterParams(filter_on=False),
            sketch_params=params))
    with open(path, "wb") as f:
        f.write(write_finch_file(sketches))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--max-dist", type=float, default=0.1)
    args = ap.parse_args()

    cache = os.path.join(REPO, ".scratch")
    os.makedirs(cache, exist_ok=True)
    db = os.path.join(cache, f"bench_cli_db_{args.n}_{args.k}.bsk")
    if not os.path.exists(db):
        t0 = time.perf_counter()
        build_db(db, args.n, args.k)
        print(f"# built {db} in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)

    from finch_tpu import cli
    from finch_tpu.parallel import mxu_dist

    out = os.path.join(cache, "bench_cli_out.json")
    t_load = [0.0]
    t_surv = [0.0]
    surv_used = [False]
    t0 = time.perf_counter()

    # phase probes: wrap the CLI's load symbol and the survivor-compaction
    # entry to split load / engine / emission
    orig_open = cli.open_sketch_file
    orig_surv = mxu_dist.all_pairs_survivors

    def timed_open(path):
        t = time.perf_counter()
        r = orig_open(path)
        t_load[0] += time.perf_counter() - t
        return r

    def timed_surv(*a, **kw):
        t = time.perf_counter()
        r = orig_surv(*a, **kw)
        t_surv[0] += time.perf_counter() - t
        surv_used[0] = r is not None
        return r

    cli.open_sketch_file = timed_open
    mxu_dist.all_pairs_survivors = timed_surv
    try:
        cli.run(["dist", "--pairwise", "--max-dist", str(args.max_dist),
                 db, "-o", out])
    finally:
        cli.open_sketch_file = orig_open
        mxu_dist.all_pairs_survivors = orig_surv
    dt = time.perf_counter() - t0

    with open(out) as f:
        rows = json.load(f)
    pairs = args.n * args.n
    print(json.dumps({
        "n": args.n, "k": args.k,
        "wall_s": round(dt, 2),
        "db_load_s": round(t_load[0], 2),
        "survivors_s": round(t_surv[0], 2),
        "survivors_path": surv_used[0],
        "pairs_per_s_e2e": round(pairs / dt, 1),
        "emitted_rows": len(rows),
    }))


if __name__ == "__main__":
    main()
