"""End-to-end file -> sketch benchmark: the reference's own yardstick.

The reference's headline number is sketching a 4.8 GB FASTQ (n=10,000) in
99 s on an Early-2015 MacBook Pro (/root/reference/README.md:112-121),
i.e. ~48 MB/s ~= 4.0e7 k-mers/s single-core. This benchmark reproduces
that protocol with a synthetic FASTQ of configurable size and reports
MB/s, k-mers/s, and sketches/s for the full pipeline: streaming parallel
parse -> engine -> filter -> finalize.

    python benchmarks/bench_e2e.py [--gb 4.8] [--backend numpy|jax|auto]
                                   [--threads N] [--keep]

`--backend numpy` gives the host-side end-to-end rate and bench.py the
device-side step rate; with a GPU, `--backend auto` streams packed
batches to the device, and end to end is bounded by
min(parse rate x threads, device rate).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def generate_fastq(path: str, target_bytes: int) -> None:
    """Vectorized synthetic FASTQ writer (~GB/s): 150bp reads over a
    40 Mb random genome (metagenome-scale distinct-k-mer count, like the
    reference's SRR5132341 benchmark input) with 1% substitution errors —
    the error tail dominates the distinct-hash population exactly as in
    real FASTQs, which is what makes the admission threshold effective."""
    import numpy as np

    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    read_len = 150
    genome = rng.integers(0, 4, size=40_000_000, dtype=np.int64)
    rec_overhead = len(b"@r12345678\n\n+\n\n") + read_len
    n_reads = target_bytes // (read_len + rec_overhead)
    block = 200_000
    with open(path, "wb") as f:
        written = 0
        for b0 in range(0, n_reads, block):
            nb = min(block, n_reads - b0)
            starts = rng.integers(0, len(genome) - read_len, size=nb)
            idx = starts[:, None] + np.arange(read_len)[None, :]
            reads = bases[genome[idx]]
            # 1% substitution errors
            nerr = int(nb * read_len * 0.01)
            er = rng.integers(0, nb, size=nerr)
            ec = rng.integers(0, read_len, size=nerr)
            reads[er, ec] = bases[rng.integers(0, 4, size=nerr)]
            # sample both strands (the strand filter removes k-mers seen
            # only one way, filtering.rs:413-432)
            comp = np.zeros(256, dtype=np.uint8)
            comp[ord("A")], comp[ord("C")] = ord("T"), ord("G")
            comp[ord("G")], comp[ord("T")] = ord("C"), ord("A")
            flip = rng.random(nb) < 0.5
            reads[flip] = comp[reads[flip, ::-1]]
            qual = np.full((nb, read_len), ord("I"), dtype=np.uint8)
            names = [b"@r%08d" % (b0 + i) for i in range(nb)]
            parts = []
            for i in range(nb):
                parts.append(names[i])
                parts.append(b"\n")
                parts.append(reads[i].tobytes())
                parts.append(b"\n+\n")
                parts.append(qual[i].tobytes())
                parts.append(b"\n")
            chunk = b"".join(parts)
            f.write(chunk)
            written += len(chunk)
    print(f"generated {written/1e9:.2f} GB FASTQ at {path}",
          file=sys.stderr)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0,
                    help="synthetic FASTQ size in GB (reference used 4.8)")
    ap.add_argument("--backend", default="native",
                    choices=["numpy", "native", "jax", "auto"])
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--n-hashes", type=int, default=10_000)
    ap.add_argument("--keep", action="store_true",
                    help="keep the generated FASTQ for reruns")
    args = ap.parse_args()

    import finch_tpu as ft

    path = f"/tmp/finch_tpu_e2e_{args.gb:g}gb.fastq"
    if not os.path.exists(path):
        generate_fastq(path, int(args.gb * 1e9))
    size = os.path.getsize(path)

    params = ft.SketchParams.mash(
        kmers_to_sketch=args.n_hashes * 200, final_size=args.n_hashes)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)

    t0 = time.perf_counter()
    [sketch] = ft.sketch_files([path], params, filters,
                               backend=args.backend)
    dt = time.perf_counter() - t0

    kmers = sketch.num_valid_kmers
    result = {
        "metric": "e2e_sketch_mb_per_sec",
        "value": round(size / dt / 1e6, 1),
        "unit": "MB/s",
        "kmers_per_sec": round(kmers / dt, 1),
        "sketches_per_sec": round(1.0 / dt, 5),
        "seconds": round(dt, 2),
        "file_gb": round(size / 1e9, 3),
        "n_hashes": args.n_hashes,
        "backend": args.backend,
        "sketch_len": len(sketch.hashes),
        # reference yardstick: 4.8 GB / 99 s (README.md:116-119)
        "vs_reference_48mb_s": round(size / dt / 1e6 / 48.0, 2),
    }
    print(json.dumps(result))
    if not args.keep:
        os.unlink(path)


if __name__ == "__main__":
    main()
