"""Pure-Python streaming reference oracle.

A deliberately slow, line-for-line faithful transcription of the reference
algorithms, used ONLY in tests to property-check the batched device pipeline:

* bottom-k ("mash") streaming sketcher  — /root/reference/lib/src/sketch_schemes/mash.rs:34-63
* scaled sketcher                       — /root/reference/lib/src/sketch_schemes/scaled.rs:37-61
* needletail-0.5.0 normalize/canonical_kmers semantics as consumed by finch
  (mash.rs:67-80)

Not part of the production path.
"""

from __future__ import annotations

import heapq

M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _fmix64(x: int) -> int:
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & M64
    x ^= x >> 33
    return x


def murmur3_x64_128(key: bytes, seed: int = 0) -> tuple[int, int]:
    """MurmurHash3 x64 128-bit variant (public-domain algorithm)."""
    n = len(key)
    h1 = h2 = seed & M64
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(key[16 * i : 16 * i + 8], "little")
        k2 = int.from_bytes(key[16 * i + 8 : 16 * i + 16], "little")
        k1 = (k1 * c1) & M64
        k1 = _rotl(k1, 31)
        k1 = (k1 * c2) & M64
        h1 ^= k1
        h1 = _rotl(h1, 27)
        h1 = (h1 + h2) & M64
        h1 = (h1 * 5 + 0x52DCE729) & M64
        k2 = (k2 * c2) & M64
        k2 = _rotl(k2, 33)
        k2 = (k2 * c1) & M64
        h2 ^= k2
        h2 = _rotl(h2, 31)
        h2 = (h2 + h1) & M64
        h2 = (h2 * 5 + 0x38495AB5) & M64
    tail = key[nblocks * 16 :]
    k1 = k2 = 0
    t = len(tail)
    for i in range(min(t, 15), 8, -1):
        k2 ^= tail[i - 1] << (8 * (i - 9))
    if t > 8:
        k2 = (k2 * c2) & M64
        k2 = _rotl(k2, 33)
        k2 = (k2 * c1) & M64
        h2 ^= k2
    for i in range(min(t, 8), 0, -1):
        k1 ^= tail[i - 1] << (8 * (i - 1))
    if t > 0:
        k1 = (k1 * c1) & M64
        k1 = _rotl(k1, 31)
        k1 = (k1 * c2) & M64
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & M64
    h2 = (h2 + h1) & M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & M64
    h2 = (h2 + h1) & M64
    return h1, h2


def hash_f(kmer: bytes, seed: int) -> int:
    """finch's hash: low 64 bits of murmur3 x64_128 (hashing.rs:10-12)."""
    return murmur3_x64_128(kmer, seed)[0]


_COMP = {65: 84, 84: 65, 67: 71, 71: 67}


def normalize(seq: bytes) -> bytes:
    """needletail normalize(iupac=false) as used at mash.rs:73."""
    out = bytearray()
    for b in seq:
        c = chr(b)
        if c in "ACGT":
            out.append(b)
        elif c in "acg":
            out.append(b - 32)
        elif c in "tuU":
            out.append(84)
        elif c in "\n\r \t":
            pass
        elif c in ".~-":
            out.append(ord("-"))
        else:
            out.append(ord("N"))
    return bytes(out)


def reverse_complement(seq: bytes) -> bytes:
    # non-ACGT (N, -) pass through unchanged, as in needletail's complement
    return bytes(_COMP.get(b, b) for b in reversed(seq))


def canonical_kmers(norm_seq: bytes, k: int):
    """Yield (kmer_bytes, is_rc) for valid windows; skip windows containing
    non-ACGT bases. Canonical = lexicographic min(fwd, rc); ties -> rc."""
    rc = reverse_complement(norm_seq)
    n = len(norm_seq)
    good = [chr(c) in "ACGT" for c in norm_seq]
    run = 0
    for p in range(n):
        run = run + 1 if good[p] else 0
        if run >= k:
            start = p - k + 1
            fwd = norm_seq[start : start + k]
            r = rc[n - start - k : n - start]
            if fwd < r:
                yield fwd, False
            else:
                yield r, True


class OracleMashSketcher:
    """Streaming bottom-k with counts (mash.rs:10-113)."""

    def __init__(self, size: int, k: int, seed: int):
        self.size = size
        self.k = k
        self.seed = seed
        self.heap: list[tuple[int, bytes]] = []  # max-heap via negation
        self.counts: dict[int, tuple[int, int]] = {}
        self.total_kmers = 0
        self.total_bases = 0

    def push(self, kmer: bytes, extra: int) -> None:
        self.total_kmers += 1
        h = hash_f(kmer, self.seed)
        add = (not self.heap) or (h <= -self.heap[0][0]) or (
            len(self.heap) < self.size)
        if add:
            if h in self.counts:
                c, e = self.counts[h]
                self.counts[h] = (min(c + 1, M64 >> 32), min(e + extra, M64 >> 32))
            else:
                heapq.heappush(self.heap, (-h, kmer))
                self.counts[h] = (1, extra)
                if len(self.heap) > self.size:
                    nh, _ = heapq.heappop(self.heap)
                    del self.counts[-nh]

    def process(self, raw_seq: bytes) -> None:
        self.total_bases += len(raw_seq)
        for kmer, is_rc in canonical_kmers(normalize(raw_seq), self.k):
            self.push(kmer, int(is_rc))

    def to_vec(self):
        out = []
        for nh, kmer in sorted((-h, km) for h, km in self.heap):
            c, e = self.counts[nh]
            out.append((nh, kmer, c, e))
        return out


class OracleScaledSketcher:
    """Streaming scaled sketcher (scaled.rs:21-61)."""

    def __init__(self, size: int, scale: float, k: int, seed: int):
        self.size = size
        self.k = k
        self.seed = seed
        iscale = int(1.0 / scale)
        self.max_hash = ((1 << 64) - 1) // iscale if iscale else M64
        self.heap: list[tuple[int, bytes]] = []
        self.counts: dict[int, tuple[int, int]] = {}
        self.total_kmers = 0
        self.total_bases = 0

    def push(self, kmer: bytes, extra: int) -> None:
        self.total_kmers += 1
        h = hash_f(kmer, self.seed)
        if h <= self.max_hash or (len(self.heap) <= self.size and self.size != 0):
            if h in self.counts:
                c, e = self.counts[h]
                self.counts[h] = (min(c + 1, M64 >> 32), min(e + extra, M64 >> 32))
            else:
                heapq.heappush(self.heap, (-h, kmer))
                self.counts[h] = (1, extra)
                if (len(self.heap) > self.size
                        and -self.heap[0][0] > self.max_hash):
                    nh, _ = heapq.heappop(self.heap)
                    del self.counts[-nh]

    def process(self, raw_seq: bytes) -> None:
        self.total_bases += len(raw_seq)
        for kmer, is_rc in canonical_kmers(normalize(raw_seq), self.k):
            self.push(kmer, int(is_rc))

    def to_vec(self):
        out = []
        for nh, kmer in sorted((-h, km) for h, km in self.heap):
            c, e = self.counts[nh]
            out.append((nh, kmer, c, e))
        return out
