"""10k x 10k all-vs-all distance benchmark (BASELINE config 5), run for
real — not extrapolated — on one device via the Gram-matrix engine
(finch_tpu/parallel/mxu_dist.py).

Generates a clustered sketch DB (100 clusters x 100 sketches sharing
~20% of their hashes within a cluster — RefSeq-like relatedness) plus a
disjoint control DB, and reports (query, ref) pairs/s for the on-device
integer-stats phase and the end-to-end figure including the host i/j
closed-form phase.

    python benchmarks/bench_dist10k.py [--n 10000] [--k 1000]

The DB upload (N*K*8 bytes) happens once; timed iterations xor-perturb
the device copy (xor preserves hash equality structure, so the workload
is identical) and end in block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def clustered_db(rng, n, k, n_clusters=100, share=0.2):
    """Cluster members draw `share` of their hashes from a per-cluster
    pool (pairwise jaccard ~ share^2/(2-share^2) within a cluster)."""
    per = n // n_clusters
    out = np.empty((n, k), dtype=np.uint64)
    n_shared = int(k * share)
    for c in range(n_clusters):
        pool = rng.choice(1 << 62, size=k * 4, replace=False).astype(np.uint64)
        for m in range(per):
            shared = rng.choice(pool, size=n_shared, replace=False)
            priv = rng.choice(1 << 62, size=k - n_shared,
                              replace=False).astype(np.uint64)
            out[c * per + m] = np.sort(
                np.unique(np.concatenate([shared, priv]))[:k])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=1_000)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from finch_tpu.parallel.mxu_dist import (_below_counts_device_sorted,
                                             _gram_accumulate,
                                             _shared_incidences)

    rng = np.random.default_rng(7)
    n, k = args.n, args.k
    results = {}
    for name, H in (
            ("clustered", clustered_db(rng, n, k)),
            ("disjoint", np.sort(
                rng.choice(1 << 62, size=(n * k), replace=False)
                .astype(np.uint64).reshape(n, k), axis=1)),
    ):
        lengths = np.full(n, k, dtype=np.int32)
        flat_s = np.tile(np.arange(n, dtype=np.int32)[:, None],
                         (1, k)).reshape(-1)
        cap = n * k
        page = 2
        while page < n + 1:
            page *= 2
        page = min(page, cap)

        dev_h = jnp.asarray(H.reshape(-1))
        dev_s = jnp.asarray(flat_s)

        def run(h, int8=False):
            rid, sid, n_shared, _ = _shared_incidences(h, dev_s, cap)
            common = _gram_accumulate(rid, sid, n_shared, n, page,
                                      int8=int8)
            return common, n_shared

        # warm/compile
        common, n_shared = run(dev_h)
        common_base = np.asarray(common)
        best = 9e9
        for rep in range(args.reps):
            h = dev_h ^ jnp.uint64(rng.integers(1, 1 << 40))
            jax.block_until_ready(h)
            t0 = time.perf_counter()
            common, n_shared = jax.block_until_ready(run(h))
            best = min(best, time.perf_counter() - t0)

        # same-session int8 A/B (the FINCH_TPU_GRAM_INT8 default
        # decision): identical workload, int8 inputs + int32
        # accumulation, exactness checked against the bf16/f32 run
        c8, _ = run(dev_h, int8=True)
        assert np.array_equal(np.asarray(c8), common_base), \
            "int8 Gram diverged from bf16/f32"
        best8 = 9e9
        for rep in range(args.reps):
            h = dev_h ^ jnp.uint64(rng.integers(1, 1 << 40))
            jax.block_until_ready(h)
            t0 = time.perf_counter()
            c8, _ = jax.block_until_ready(run(h, int8=True))
            best8 = min(best8, time.perf_counter() - t0)
        # i/j phase (closed-form pointer ends), fully on-device; the
        # result stays device-resident for downstream masking
        maxima = np.sort(H[:, -1])
        dev_H = jnp.asarray(H)
        dev_m = jnp.asarray(maxima)
        jax.block_until_ready(
            _below_counts_device_sorted(dev_H, dev_m))  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(_below_counts_device_sorted(
            dev_H ^ jnp.uint64(2), dev_m ^ jnp.uint64(2)))
        t_ij = time.perf_counter() - t0
        results[name] = {
            "device_s": round(best, 3),
            "device_s_int8": round(best8, 3),
            "ij_device_s": round(t_ij, 3),
            "pairs_per_sec_device": round(n * n / best, 0),
            "pairs_per_sec_total": round(n * n / (best + t_ij), 0),
            "n_shared_incidences": int(n_shared),
        }

    out = {
        "metric": "allvsall_pairs_per_sec_10kx10k",
        "value": results["clustered"]["pairs_per_sec_total"],
        "unit": "pairs/s",
        "n": n, "k": k,
        "detail": results,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
