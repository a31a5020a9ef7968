"""Sketching engines: fold k-mer batches into a sketch.

Two interchangeable, bit-identical backends:

* JaxEngine  — the device path: vectorized murmur + sort/dedup/top-k
               (ops/murmur3.py, ops/bottomk.py).
* NumpyEngine — host path for small inputs and as an independent oracle
               (hashes via the C++ murmur, reductions in NumPy).

Both compute the batch form of the reference's streaming heaps:
mash  — bottom-K distinct hashes, counts = total stream occurrences
        (mash.rs:34-63 of /root/reference/lib/src/sketch_schemes/)
scaled — all distinct hashes <= max_hash plus the smallest above-threshold
        hashes topped up to `size` total (scaled.rs:37-61)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from finch_tpu.errors import FinchMessageError

from finch_tpu.models.params import SketchParams, U32_MAX, U64_MAX
from finch_tpu.native import murmur3_packed, unpack_kmers
from finch_tpu.core.sketch import KmerCount


def _retention_keep(params: SketchParams, h: np.ndarray) -> int:
    """How many leading entries of the ascending-hash candidate array the
    scheme retains (mash: size; scaled: all <= max_hash topped up to
    size; none: everything)."""
    if params.sketch_type == "scaled":
        below = int(np.searchsorted(h, np.uint64(params.max_hash()),
                                    side="right"))
        return below + max(0, params.kmers_to_sketch - below)
    if params.sketch_type == "mash":
        return params.kmers_to_sketch
    return len(h)


def _is_bytes_payload(pk) -> bool:
    """xwide (k >= 64) payloads are (n, k) uint8 ASCII matrices rather
    than packed code words."""
    return (isinstance(pk, np.ndarray) and pk.ndim == 2
            and pk.dtype == np.uint8)


def _finalize_arrays(params: SketchParams, h, c, e, pk):
    """Retention rule + u32 count saturation on arrays (the object-free
    fast path; kmers stay packed until the final survivors are known).
    `pk` is one u64 code array for k <= 31, a (plo, phi) tuple of word
    arrays on the wide (32..=63) path, or an (n, k) uint8 ASCII matrix on
    the xwide (k >= 64) path."""
    h = np.asarray(h, dtype=np.uint64)
    c = np.asarray(c, dtype=np.uint64)
    e = np.asarray(e, dtype=np.uint64)
    if isinstance(pk, tuple):
        pks = [np.asarray(w, dtype=np.uint64) for w in pk]
    elif _is_bytes_payload(pk):
        pks = [pk]
    else:
        pks = [np.asarray(pk, dtype=np.uint64)]
    real = c > 0
    h, c, e = h[real], c[real], e[real]
    pks = [w[real] for w in pks]
    keep = _retention_keep(params, h)
    h, c, e = h[:keep], c[:keep], e[:keep]
    pks = [w[:keep] for w in pks]
    c = np.minimum(c, np.uint64(U32_MAX)).astype(np.uint32)
    e = np.minimum(e, np.uint64(U32_MAX)).astype(np.uint32)
    return h, c, e, (tuple(pks) if len(pks) == 2 else pks[0])


def kmercounts_from_arrays(params: SketchParams, h, c, e, pk):
    """Materialize KmerCount objects (ascending hash) from arrays."""
    if isinstance(pk, tuple):
        from finch_tpu.native import unpack_kmers_w

        kmer_bytes = unpack_kmers_w(
            np.asarray(pk[0], dtype=np.uint64),
            np.asarray(pk[1], dtype=np.uint64), params.k)
    elif _is_bytes_payload(pk):
        kmer_bytes = pk  # already ASCII windows
    else:
        kmer_bytes = unpack_kmers(np.asarray(pk, dtype=np.uint64), params.k)
    return [
        KmerCount(hash=int(h[i]), kmer=bytes(kmer_bytes[i]),
                  count=int(c[i]), extra_count=int(e[i]))
        for i in range(len(h))
    ]


def _finalize(params: SketchParams, h, c, e, pk):
    """Shared finalization: apply the scheme's retention rule and build the
    ascending-hash KmerCount list (counts saturate to u32, matching the
    reference's saturating_add accumulation)."""
    return kmercounts_from_arrays(
        params, *_finalize_arrays(params, h, c, e, pk))


class NumpyEngine:
    """Exact host-side batch sketcher."""

    def __init__(self, params: SketchParams):
        self.params = params
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.h = np.empty(0, dtype=np.uint64)
        self.c = np.empty(0, dtype=np.uint64)
        self.e = np.empty(0, dtype=np.uint64)
        # payload: one word for k <= 31, (lo, hi) words for 32 <= k <= 63,
        # an (n, k) ASCII byte matrix for k >= 64 (xwide)
        self.xwide = params.k > 63
        self.wide = 31 < params.k <= 63
        if self.xwide:
            self.pks = [np.empty((0, params.k), dtype=np.uint8)]
        else:
            nw = 2 if self.wide else 1
            self.pks = [np.empty(0, dtype=np.uint64) for _ in range(nw)]

    @property
    def pk(self):
        return tuple(self.pks) if self.wide else self.pks[0]

    def _threshold(self) -> int:
        if self.params.sketch_type == "mash":
            if self.size == 0:
                return -1  # nothing is ever admitted
            if len(self.h) >= self.size:
                return int(self.h[self.size - 1])
            return int(U64_MAX)
        # scaled: the state retains all distinct hashes <= max_hash plus the
        # `size` smallest above-threshold candidates.
        if self.size == 0:
            return self.max_hash
        below = int(np.searchsorted(self.h, np.uint64(self.max_hash),
                                    side="right"))
        n_above = len(self.h) - below
        if n_above >= self.size:
            return max(self.max_hash, int(self.h[-1]))
        return int(U64_MAX)

    def update(self, packed, rc: np.ndarray) -> None:
        if self.xwide:
            from finch_tpu.native import murmur3_batch

            kb = np.ascontiguousarray(packed, dtype=np.uint8)
            hashes = murmur3_batch(kb, self.params.hash_seed)
            pk_words = [kb]
        elif self.wide:
            from finch_tpu.native import murmur3_packed_w

            plo, phi = packed
            hashes = murmur3_packed_w(plo, phi, self.params.k,
                                      self.params.hash_seed)
            pk_words = [np.asarray(plo, dtype=np.uint64),
                        np.asarray(phi, dtype=np.uint64)]
        else:
            hashes = murmur3_packed(packed, self.params.k,
                                    self.params.hash_seed)
            pk_words = [np.asarray(packed, dtype=np.uint64)]
        thresh = self._threshold()
        if thresh < 0:
            mask = np.zeros(len(hashes), dtype=bool)
        else:
            mask = hashes <= np.uint64(thresh)
        hashes = hashes[mask]
        pk_words = [w[mask] for w in pk_words]
        rc = np.asarray(rc)[mask].astype(np.uint64)

        h = np.concatenate([self.h, hashes])
        c = np.concatenate([self.c, np.ones(len(hashes), dtype=np.uint64)])
        e = np.concatenate([self.e, rc])
        pks = [np.concatenate([s, w]) for s, w in zip(self.pks, pk_words)]
        order = np.argsort(h, kind="stable")
        h, c, e = h[order], c[order], e[order]
        pks = [w[order] for w in pks]
        if len(h):
            boundary = np.empty(len(h), dtype=bool)
            boundary[0] = True
            np.not_equal(h[1:], h[:-1], out=boundary[1:])
            idx = np.flatnonzero(boundary)
            h = h[idx]
            c = np.add.reduceat(c, idx)
            e = np.add.reduceat(e, idx)
            pks = [w[idx] for w in pks]  # stable: first-seen kmer per hash
        # retention rule
        if self.params.sketch_type == "mash":
            keep = self.size
        else:
            below = int(np.searchsorted(h, np.uint64(self.max_hash),
                                        side="right"))
            keep = below + self.size
        self.h, self.c, self.e = h[:keep], c[:keep], e[:keep]
        self.pks = [w[:keep] for w in pks]

    def finalize(self):
        return _finalize(self.params, self.h, self.c, self.e, self.pk)

    def finalize_arrays(self):
        return _finalize_arrays(self.params, self.h, self.c, self.e, self.pk)


class NativeEngine:
    """Production host path: the C++ fold (identity-hash table + adaptive
    admission threshold, finch_native.cpp) at reference-heap speeds;
    bit-identical to NumpyEngine (tests/test_sketchers.py pins it)."""

    def __init__(self, params: SketchParams):
        from finch_tpu.native import NativeFold

        self.params = params
        if params.k > 31:
            # the identity-hash fold table stores one u64 payload word (a
            # k <= 31 speed optimization); wide k runs the vectorized
            # NumPy fold instead — same exact semantics, host path
            self._fold = None
            self._wide_impl = NumpyEngine(params)
            return
        scheme = 1 if params.sketch_type == "scaled" else 0
        max_hash = params.max_hash() if scheme else 0
        self._fold = NativeFold(scheme, params.k, params.hash_seed,
                                params.kmers_to_sketch, max_hash or 0)

    def update(self, packed, rc: np.ndarray) -> None:
        if self._fold is None:
            self._wide_impl.update(packed, rc)
            return
        self._fold.fold(packed, rc)

    def state_arrays(self):
        """(h, c, e, pk) retained-candidate arrays, ascending hash, with
        the retention rule applied — interchangeable with NumpyEngine's
        internal state for engine migration."""
        if self._fold is None:
            w = self._wide_impl
            keep = _retention_keep(self.params, w.h)
            pk_s = [x[:keep] for x in w.pks]
            # payload form matches NumpyEngine.pk: word tuple for wide,
            # single (n, k) byte matrix for xwide
            return (w.h[:keep], w.c[:keep], w.e[:keep],
                    tuple(pk_s) if len(pk_s) == 2 else pk_s[0])
        h, c, e, pk = self._fold.result()
        keep = _retention_keep(self.params, h)
        return h[:keep], c[:keep], e[:keep], pk[:keep]

    def finalize(self):
        return _finalize(self.params, *self.state_arrays())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self.state_arrays())


class JaxEngine:
    """Device batch sketcher: fixed-capacity device state, jitted steps."""

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21):
        import jax.numpy as jnp

        from finch_tpu.ops import bottomk

        self._xwide_impl = None
        if params.k > 63:
            # xwide payloads are per-kmer byte windows, not the fixed-word
            # codes the device state carries; fold on the host (the
            # reference's own path for any k is a serial host loop)
            self._xwide_impl = NumpyEngine(params)
            self.params = params
            self.wants_composite = False
            return
        self._jnp = jnp
        self._bottomk = bottomk
        self.params = params
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.batch_size = batch_size
        self.wide = params.k > 31
        # initial capacity: mash is fixed at kmers_to_sketch; scaled starts
        # small and grows when below-threshold distinct hashes approach it.
        if params.sketch_type == "mash":
            self.capacity = max(1, self.size)
        else:
            self.capacity = max(2 * self.size, 1 << 12)
        if self.wide:
            from finch_tpu.ops import bottomk_wide

            self._bkw = bottomk_wide
            self.state = bottomk_wide.empty_state(self.capacity)
        else:
            self.state = bottomk.empty_state(self.capacity)
        self._mh = (jnp.uint64(self.max_hash) if self.max_hash is not None
                    else jnp.uint64(0))
        # the reader ships u64 packed + u8 rc; the composite u32-plane
        # form (8 B instead of 9 B per k-mer) is an open A/B
        self.wants_composite = False

    @staticmethod
    def _bucket(n: int) -> int:
        from finch_tpu.ops.bottomk import bucket_pow2

        return bucket_pow2(n)

    def _pad(self, arr, dtype):
        jnp = self._jnp
        n = len(arr)
        b = self._bucket(n)
        if n == b:
            return jnp.asarray(arr, dtype=dtype)
        out = np.zeros(b, dtype=dtype)
        out[:n] = arr
        return jnp.asarray(out)

    def update(self, packed, rc: np.ndarray) -> None:
        if self._xwide_impl is not None:
            self._xwide_impl.update(packed, rc)
            return
        if self.wide:
            plo, phi = packed
            n = len(plo)
            for off in range(0, max(n, 1), self.batch_size):
                sl = slice(off, off + self.batch_size)
                if len(plo[sl]) == 0:
                    break
                self._step_wide(plo[sl], phi[sl], rc[sl])
            return
        n = len(packed)
        for off in range(0, max(n, 1), self.batch_size):
            chunk_pk = packed[off: off + self.batch_size]
            chunk_rc = rc[off: off + self.batch_size]
            if len(chunk_pk) == 0:
                break
            self._step(chunk_pk, chunk_rc)

    def _step_wide(self, plo, phi, rc):
        jnp = self._jnp
        nvalid = jnp.uint32(len(plo))
        plo_d = self._pad(plo, np.uint64)
        phi_d = self._pad(phi, np.uint64)
        rc_d = self._pad(rc, np.uint8)
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            new_state, below = self._bkw.sketch_step(
                self.state, plo_d, phi_d, rc_d, nvalid, self._mh,
                k=self.params.k, seed=self.params.hash_seed,
                has_max_hash=is_scaled)
            if not is_scaled:
                self.state = new_state
                return
            below = int(below)
            if below + self.size <= self.capacity:
                self.state = new_state
                return
            new_cap = max(self.capacity * 2, below + self.size)
            self.state = self._bkw.grow_state(self.state, new_cap)
            self.capacity = new_cap

    def _step(self, chunk_pk, chunk_rc):
        jnp = self._jnp
        bk = self._bottomk
        nvalid = jnp.uint32(len(chunk_pk))
        composite = chunk_pk.dtype == np.uint32
        if composite:
            pk_d = self._pad(chunk_pk, np.uint32)
            rc_d = self._pad(chunk_rc, np.uint32)
        else:
            pk_d = self._pad(chunk_pk, np.uint64)
            rc_d = self._pad(chunk_rc, np.uint8)
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            new_state, below = bk.sketch_step(
                self.state, pk_d, rc_d, nvalid, self._mh,
                k=self.params.k, seed=self.params.hash_seed,
                has_max_hash=is_scaled, composite=composite)
            if not is_scaled:
                self.state = new_state
                return
            below = int(below)
            if below + self.size <= self.capacity:
                self.state = new_state
                return
            # grow capacity and redo from the unmodified previous state
            new_cap = max(self.capacity * 2, below + self.size)
            template = bk.empty_state(new_cap)
            self.state = bk.grow_state(self.state, template)
            self.capacity = new_cap

    def _host_state(self):
        if self.wide:
            h, c, e, plo, phi = self._bkw.state_arrays(self.state)
            return h, c, e, (plo, phi)
        state, _ = self._bottomk.flush_state(
            self.state, self._mh, k=self.params.k,
            seed=self.params.hash_seed)
        sh, sc, se, spk = state[:4]
        return (np.asarray(sh), np.asarray(sc), np.asarray(se),
                np.asarray(spk))

    def finalize(self):
        if self._xwide_impl is not None:
            return self._xwide_impl.finalize()
        return _finalize(self.params, *self._host_state())

    def finalize_arrays(self):
        if self._xwide_impl is not None:
            return self._xwide_impl.finalize_arrays()
        return _finalize_arrays(self.params, *self._host_state())




class HybridEngine:
    """Host engine that migrates to the device engine for large streams.

    Small inputs finish on the host (no compile latency); once the stream
    crosses `switch_after` k-mers, the accumulated host state — already the
    exact sorted bottom-k with counts — seeds a device state and sketching
    continues on the accelerator. Bit-identical either way.
    """

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21,
                 switch_after: int = 4 << 20):
        self.params = params
        self.batch_size = batch_size
        self.switch_after = switch_after
        self._host = NativeEngine(params)
        self._dev: Optional[JaxEngine] = None
        self._seen = 0
        self.wants_composite = False

    def _migrate(self) -> None:
        import jax.numpy as jnp

        dev = JaxEngine(self.params, batch_size=self.batch_size)
        hh, hc, he, hpk = self._host.state_arrays()
        n = len(hh)
        while dev.capacity < n:
            # scaled host state may exceed the initial device capacity
            from finch_tpu.ops import bottomk

            dev.capacity *= 2
            dev.state = bottomk.empty_state(dev.capacity)
        sh, sc, se, spk, spill, fill = dev.state
        dev.state = (
            sh.at[:n].set(jnp.asarray(hh)),
            sc.at[:n].set(jnp.asarray(hc)),
            se.at[:n].set(jnp.asarray(he)),
            spk.at[:n].set(jnp.asarray(hpk)),
            spill, fill,
        )
        self._dev = dev
        self._host = None

    def update(self, packed, rc: np.ndarray) -> None:
        if self.params.k > 31:
            # wide k stays on the host fold (NativeEngine -> NumPy); the
            # device migration path is a narrow-k throughput optimization
            self._host.update(packed, rc)
            return
        if self._dev is None:
            if packed.dtype == np.uint32:
                # composite planes: decode for the host fold
                comp = ((rc.astype(np.uint64) << np.uint64(32))
                        | packed.astype(np.uint64))
                pk = comp >> np.uint64(1)
                rcb = (packed & np.uint32(1)).astype(np.uint8)
                self._host.update(pk, rcb)
            else:
                self._host.update(packed, rc)
            self._seen += len(packed)
            if self._seen >= self.switch_after:
                self._migrate()
        else:
            self._dev.update(packed, rc)

    def finalize(self):
        return (self._host or self._dev).finalize()

    def finalize_arrays(self):
        return (self._host or self._dev).finalize_arrays()


def _accelerator_present() -> bool:
    """True unless JAX's default backend is the CPU. A backend that fails
    to initialise raises: a broken GPU runtime must not quietly send
    `auto` to the host fold."""
    import jax

    return jax.default_backend() != "cpu"


def _mesh_engine(params: SketchParams, batch_size: int):
    """Data-parallel sketching over every visible device
    (parallel/sharded_sketch.py); bit-identical to the host engines."""
    import jax

    from finch_tpu.parallel import ShardedSketchEngine, make_mesh

    n = len(jax.devices())
    mesh = make_mesh(n)
    return ShardedSketchEngine(
        params, mesh,
        batch_size_per_device=max(batch_size // n, 1 << 14))


def make_engine(params: SketchParams, backend: str = "auto",
                batch_size: int = 1 << 21):
    if backend == "numpy":
        return NumpyEngine(params)
    if backend == "native":
        return NativeEngine(params)
    if backend == "jax":
        return JaxEngine(params, batch_size=batch_size)
    if backend == "mesh":
        if params.k > 31:
            raise FinchMessageError(
                "the mesh backend supports k <= 31; wide k-mers run on the "
                "numpy/native/jax backends")
        return _mesh_engine(params, batch_size)
    if backend == "auto":
        if _accelerator_present():
            import jax

            if len(jax.devices()) > 1 and params.k <= 31:
                # multi-chip host: shard the stream over the whole mesh
                return _mesh_engine(params, batch_size)
            return HybridEngine(params, batch_size=batch_size)
        return NativeEngine(params)
    raise FinchMessageError(f"unknown backend {backend!r}")
