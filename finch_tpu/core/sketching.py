"""Sketching drivers — the equivalents of finch's library API
(/root/reference/lib/src/lib.rs:29-94 `sketch_files` / `sketch_stream`).

A sketch job streams batches of packed canonical k-mers from the C++ parser
into a sketching engine (device or host backend), then applies filtering and
the scheme's post-filter rule on the (small) candidate set.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np

from finch_tpu.core.sketch import Sketch
from finch_tpu.models.params import FilterParams, SketchParams
from finch_tpu.models.engine import make_engine
from finch_tpu.models.allcounts import AllCountsEngine
from finch_tpu.native import FORMAT_FASTQ, KmerReader


def _make_engine(sketch_params: SketchParams, backend: str, batch_size: int):
    if sketch_params.sketch_type == "none":
        return AllCountsEngine(sketch_params)
    return make_engine(sketch_params, backend=backend, batch_size=batch_size)


def _choose_reader(source, k: int, canonical: bool, batch_size: int,
                   parser_threads: Optional[int] = None,
                   composite: bool = False):
    """Within-file parallel parsing via the native streaming pipeline
    (record-aligned chunks parsed by a C++ thread pool; O(1) memory in
    file size, BGZF-parallel gunzip) whenever more than one core is
    available; the plain serial parser otherwise. Either way the k-mer
    stream and totals are identical (tests/test_parser.py pins it)."""
    import os

    from finch_tpu.native import StreamingParallelReader

    if k > 63:
        # arbitrary-k path (the reference hashes byte windows of any k,
        # mash.rs:73-79): run-mode parser + host byte-window canonicalizer
        from finch_tpu.native import XWideReader

        return XWideReader(source, k=k, canonical=canonical,
                           batch_size=batch_size)
    if k > 31:
        # wide k-mers (32..=63) stream through the serial reader's
        # two-word path; the parallel pipeline's chunk layout is
        # single-word (narrow-k throughput machinery)
        return KmerReader(source, k=k, canonical=canonical,
                          batch_size=batch_size)
    if source == "-":
        # stdin: the serial reader streams the fd with O(1) memory
        # (lib.rs:38-43); the parallel pipeline's chunk aligner needs a
        # rewindable source
        return KmerReader(source, k=k, canonical=canonical,
                          batch_size=batch_size, composite=composite)
    cores = (os.cpu_count() or 1) if parser_threads is None \
        else parser_threads
    if cores > 1:
        return StreamingParallelReader(
            source, k=k, canonical=canonical,
            batch_size=batch_size, threads=parser_threads,
            composite=composite)
    return KmerReader(source, k=k, canonical=canonical,
                      batch_size=batch_size, composite=composite)


def _fused_native_ok(source, sketch_params: SketchParams,
                     backend: str) -> bool:
    """The fused C++ parse+fold pipeline applies when the work is
    host-bound (native backend, or auto without an accelerator), the
    source is a path, and the scheme folds by hash (not AllCounts)."""
    if sketch_params.sketch_type == "none":
        return False
    if sketch_params.k > 31:
        return False  # wide k streams through the two-word serial path
    if isinstance(source, (bytes, bytearray, memoryview)):
        return False
    if source == "-":
        return False  # stdin streams through the serial fd reader
    if backend == "native":
        return True
    if backend == "auto":
        from finch_tpu.models.engine import _accelerator_present

        return not _accelerator_present()
    return False


def sketch_stream(source, name: str, sketch_params: SketchParams,
                  filters: FilterParams, backend: str = "auto",
                  batch_size: int = 1 << 21,
                  parser_threads: Optional[int] = None) -> Sketch:
    """Sketch one FASTA/FASTQ(.gz) source (path or bytes). lib.rs:51-94."""
    from finch_tpu.utils import get_meter, metrics_enabled, report

    filter_params = filters.copy()
    if _fused_native_ok(source, sketch_params, backend):
        return _sketch_stream_fused(source, name, sketch_params,
                                    filter_params, parser_threads)
    engine = _make_engine(sketch_params, backend, batch_size)
    canonical = sketch_params.sketch_type != "none"
    reader = _choose_reader(
        source, sketch_params.k, canonical, batch_size,
        parser_threads=parser_threads,
        composite=getattr(engine, "wants_composite", False))
    parse_m = get_meter("parse_kmers")
    engine_m = get_meter("engine_kmers")

    # one-batch prefetch pipeline: the C++ parser releases the GIL, so the
    # next batch parses while the engine folds the current one (the device
    # dispatch is async as well) — host parse and device compute overlap
    def timed_next(it):
        # timed inside the worker so the meter sees parse time only, not
        # the consumer's engine time
        parse_m.start()
        batch = next(it, None)
        parse_m.stop(len(batch[0]) if batch is not None else 0)
        return batch

    def batches():
        it = iter(reader)
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(timed_next, it)
            while True:
                batch = fut.result()
                if batch is None:
                    return
                fut = pool.submit(timed_next, it)
                yield batch

    for packed, rc in batches():
        with engine_m.timed(len(packed)):
            engine.update(packed, rc)

    # FASTA disables filtering unless explicitly requested (lib.rs:71-76)
    if filter_params.filter_on is None:
        filter_params.filter_on = reader.format == FORMAT_FASTQ

    seq_length, num_valid_kmers, _ = reader.totals
    if sketch_params.sketch_type == "none":
        # AllCounts never updates total_bases (counts.rs:8,25-33) and counts
        # valid kmers via the (saturating) table sum (counts.rs:35-40)
        seq_length = 0
        num_valid_kmers = engine.num_valid_kmers()
    reader.close()

    with get_meter("finalize").timed(1):
        if hasattr(engine, "finalize_arrays"):
            # object-free fast path: filter + truncate on arrays, build
            # KmerCount objects only for the final (<= final_size) entries
            arrays = engine.finalize_arrays()
            arrays = filter_params.filter_counts_arrays(*arrays)
            arrays = sketch_params.process_post_filter(arrays, name)
            from finch_tpu.models.engine import kmercounts_from_arrays

            filtered_hashes = kmercounts_from_arrays(sketch_params, *arrays)
        else:
            hashes = engine.finalize()
            filtered_hashes = filter_params.filter_counts(hashes)
            filtered_hashes = sketch_params.process_post_filter(
                filtered_hashes, name)
    if metrics_enabled():
        report()

    return Sketch(
        name=name,
        seq_length=seq_length,
        num_valid_kmers=num_valid_kmers,
        comment="",
        hashes=filtered_hashes,
        filter_params=filter_params,
        sketch_params=sketch_params,
    )


def _sketch_stream_fused(source, name: str, sketch_params: SketchParams,
                         filter_params: FilterParams,
                         parser_threads: Optional[int]) -> Sketch:
    """One native call: parse workers fold record-aligned chunks into
    per-worker tables under a shared admission threshold; exact merge at
    EOF (finch_native.cpp sketch mode). Parse AND fold scale across
    cores with no per-batch Python hop."""
    from finch_tpu.models.engine import (_finalize_arrays,
                                         kmercounts_from_arrays)
    from finch_tpu.native import FORMAT_FASTQ as FQ, sketch_pipeline
    from finch_tpu.utils import get_meter, metrics_enabled, report

    scheme = 1 if sketch_params.sketch_type == "scaled" else 0
    max_hash = sketch_params.max_hash() if scheme else 0
    with get_meter("fused_parse_fold").timed(1):
        arrays, totals, fmt = sketch_pipeline(
            source, sketch_params.k, scheme, sketch_params.hash_seed,
            sketch_params.kmers_to_sketch, max_hash or 0,
            threads=parser_threads)
    seq_length, num_valid_kmers, _ = totals
    if filter_params.filter_on is None:
        filter_params.filter_on = fmt == FQ
    with get_meter("finalize").timed(1):
        arrays = _finalize_arrays(sketch_params, *arrays)
        arrays = filter_params.filter_counts_arrays(*arrays)
        arrays = sketch_params.process_post_filter(arrays, name)
        filtered_hashes = kmercounts_from_arrays(sketch_params, *arrays)
    if metrics_enabled():
        report()
    return Sketch(
        name=name,
        seq_length=seq_length,
        num_valid_kmers=num_valid_kmers,
        comment="",
        hashes=filtered_hashes,
        filter_params=filter_params,
        sketch_params=sketch_params,
    )


def sketch_bytes(data: bytes, name: str, sketch_params: SketchParams,
                 filters: FilterParams, backend: str = "auto") -> Sketch:
    return sketch_stream(data, name, sketch_params, filters, backend=backend)


def sketch_files(filenames: Sequence[str], sketch_params: SketchParams,
                 filters: FilterParams, backend: str = "auto",
                 batch_size: int = 1 << 21,
                 max_workers: Optional[int] = None) -> List[Sketch]:
    """Sketch many files (lib.rs:29-49). '-' reads stdin.

    Files sketch concurrently in a thread pool — the analog of the
    reference's rayon par_iter over filenames (lib.rs:34-47): the C++
    parser releases the GIL and device dispatch is async, so multi-file
    workloads scale with host cores. Results keep input order.
    """
    import concurrent.futures as cf
    import os

    def one(filename: str, parser_threads=None) -> Sketch:
        # '-' streams stdin through the fd reader with O(1) memory
        # (lib.rs:38-43) — sketch_stream/_choose_reader special-case it
        return sketch_stream(filename, filename, sketch_params, filters,
                             backend=backend, batch_size=batch_size,
                             parser_threads=parser_threads)

    if len(filenames) <= 1:
        return [one(f) for f in filenames]
    workers = max_workers or min(len(filenames), os.cpu_count() or 1)
    if workers <= 1 or "-" in filenames:  # stdin must stay serial
        return [one(f) for f in filenames]
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        # files already occupy the cores; within-file parsing stays serial
        # so memory and threads don't multiply quadratically
        return list(pool.map(lambda f: one(f, parser_threads=1),
                             filenames))
