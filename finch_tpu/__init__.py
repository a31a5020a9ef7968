"""finch_tpu — a MinHash sketching framework on accelerators, in JAX.

A from-scratch re-design of the capabilities of onecodex/finch-rs for an
accelerator (one NVIDIA H100, or four): FASTA/FASTQ records are parsed and
2-bit-packed by a C++ host layer, k-mers are hashed with a vectorized
MurmurHash3_x64_128 on the device, bottom-k sketch selection is a
batched sort/dedup/top-k over hash lanes, and distance computation runs as
Gram matrices and tiled set intersections — scaled across device meshes
with jax.sharding.

Numeric contract: hash-for-hash identical sketches and JSON-equal distances
vs the reference CLI (`finch sketch` / `finch dist`, seed=0).
"""

from finch_tpu._config import configure as _configure

_configure()

from finch_tpu.models.params import SketchParams, FilterParams  # noqa: E402
from finch_tpu.core.sketch import Sketch, KmerCount  # noqa: E402
from finch_tpu.core.sketching import sketch_files, sketch_stream, sketch_bytes  # noqa: E402
from finch_tpu.serialization import open_sketch_file  # noqa: E402
from finch_tpu.core.distance import distance  # noqa: E402
from finch_tpu.errors import FinchError  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SketchParams", "FilterParams", "Sketch", "KmerCount",
    "sketch_files", "sketch_stream", "sketch_bytes", "open_sketch_file",
    "distance", "FinchError",
]
