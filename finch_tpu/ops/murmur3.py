"""Vectorized MurmurHash3_x64_128 over 2-bit packed k-mer lanes.

This is the bit-identity root of the whole framework: finch hashes the ASCII
bytes of each canonical k-mer with MurmurHash3_x64_128 and keeps the low u64
(/root/reference/lib/src/sketch_schemes/hashing.rs:9-12). Here the k ASCII
bytes are reconstructed on-device from the packed 2-bit code (A=0 C=1 G=2
T=3, base 0 in the most-significant bits) and the hash is evaluated in
explicit (lo, hi) u32 lane pairs.

Why pairs and not u64 lanes: the pair form was chosen on an earlier
accelerator that emulated u64 arithmetic. It is ~400 u32 ops per k-mer
(6 muls per 64x64 multiply via 16-bit mulhi decomposition), which XLA
fuses into a single elementwise pass. The GPU has native 64-bit integer
multiplies; whether a plain u64 form (as in models/oracle.py) is faster
there is an open H100 A/B.

The byte->word assembly is specialized per static k (k <= 31: at most 2
16-byte blocks + tail).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from finch_tpu.errors import FinchMessageError

U32 = jnp.uint32

C1 = (np.uint32(0x114253D5), np.uint32(0x87C37B91))
C2 = (np.uint32(0x2745937F), np.uint32(0x4CF5AD43))
F1 = (np.uint32(0xED558CCD), np.uint32(0xFF51AFD7))
F2 = (np.uint32(0x1A85EC53), np.uint32(0xC4CEB9FE))
FIVE = (np.uint32(5), np.uint32(0))
A1 = (np.uint32(0x52DCE729), np.uint32(0))
A2 = (np.uint32(0x38495AB5), np.uint32(0))

# ASCII 'A','C','G','T' packed little-endian, indexed by (code << 3) shift
_BASE_LUT = np.uint32(0x54474341)


def _mulhi32(a, b):
    """High 32 bits of a*b for u32 lanes (16-bit decomposition)."""
    a0 = a & U32(0xFFFF)
    a1 = a >> U32(16)
    b0 = b & U32(0xFFFF)
    b1 = b >> U32(16)
    m00 = a0 * b0
    m01 = a0 * b1
    m10 = a1 * b0
    m11 = a1 * b1
    carry = ((m00 >> U32(16)) + (m01 & U32(0xFFFF))
             + (m10 & U32(0xFFFF))) >> U32(16)
    return m11 + (m01 >> U32(16)) + (m10 >> U32(16)) + carry


def _mul64(x, c):
    """(lo,hi) of x*c mod 2^64; x is a (lo,hi) pair of u32 arrays, c a
    constant (lo,hi) pair of np.uint32."""
    xl, xh = x
    cl, ch = c
    lo = xl * cl
    hi = _mulhi32(xl, cl) + xl * ch + xh * cl
    return lo, hi


def _add64(x, y):
    xl, xh = x
    yl, yh = y
    lo = xl + yl
    carry = (lo < xl).astype(U32)
    return lo, xh + yh + carry


def _xor64(x, y):
    return x[0] ^ y[0], x[1] ^ y[1]


def _rotl64(x, r: int):
    lo, hi = x
    if r == 32:
        return hi, lo
    if r < 32:
        return ((lo << U32(r)) | (hi >> U32(32 - r)),
                (hi << U32(r)) | (lo >> U32(32 - r)))
    s = r - 32
    return ((hi << U32(s)) | (lo >> U32(32 - s)),
            (lo << U32(s)) | (hi >> U32(32 - s)))


def _shr33_xor(x):
    """x ^= x >> 33 for a (lo,hi) pair."""
    lo, hi = x
    return lo ^ (hi >> U32(1)), hi


def _fmix64(x):
    x = _shr33_xor(x)
    x = _mul64(x, F1)
    x = _shr33_xor(x)
    x = _mul64(x, F2)
    x = _shr33_xor(x)
    return x


def _mix_k1(k1):
    k1 = _mul64(k1, C1)
    k1 = _rotl64(k1, 31)
    return _mul64(k1, C2)


def _mix_k2(k2):
    k2 = _mul64(k2, C2)
    k2 = _rotl64(k2, 33)
    return _mul64(k2, C1)


def packed_to_u32_words(packed, k: int):
    """Little-endian u32 words of the ASCII k-mer string.

    packed: u64[...] codes with base 0 in bits [2k-2, 2k-1]. Returns
    2*ceil(k/8) u32 arrays (u64 word pairs, lo first); bytes beyond k are
    zero. Code j's shift 2*(k-1-j) is even, so every code lives wholly in
    one u32 half of the packed value.
    """
    pl = packed.astype(jnp.uint64).astype(U32)
    ph = (packed.astype(jnp.uint64) >> jnp.uint64(32)).astype(U32)
    nwords = 2 * ((k + 7) // 8)
    words = []
    for w in range(nwords):
        acc = jnp.zeros_like(pl)
        for j in range(w * 4, min(k, w * 4 + 4)):
            shift = 2 * (k - 1 - j)
            if shift >= 32:
                code = (ph >> U32(shift - 32)) & U32(3)
            else:
                code = (pl >> U32(shift)) & U32(3)
            byte = (_BASE_LUT >> (code << U32(3))) & U32(0xFF)
            acc = acc | (byte << U32(8 * (j - w * 4)))
        words.append(acc)
    return words


def murmur3_x64_u32_words(words, length: int, seed: int):
    """MurmurHash3_x64_128 h1 over byte strings given as LE u32 word lanes.

    `length` is the static byte length; trailing bytes of the last words
    must be zero. Returns the (lo, hi) u32 pair of h1 per lane (the u64
    finch keeps, hashing.rs:10-12).
    """
    seed_lo = np.uint32(seed & 0xFFFFFFFF)
    seed_hi = np.uint32((seed >> 32) & 0xFFFFFFFF)
    z = jnp.zeros_like(words[0])
    h1 = (z + seed_lo, z + seed_hi)
    h2 = (z + seed_lo, z + seed_hi)
    nblocks = length // 16
    for i in range(nblocks):
        k1 = (words[4 * i], words[4 * i + 1])
        k2 = (words[4 * i + 2], words[4 * i + 3])
        h1 = _xor64(h1, _mix_k1(k1))
        h1 = _rotl64(h1, 27)
        h1 = _add64(h1, h2)
        h1 = _add64(_mul64(h1, FIVE), A1)
        h2 = _xor64(h2, _mix_k2(k2))
        h2 = _rotl64(h2, 31)
        h2 = _add64(h2, h1)
        h2 = _add64(_mul64(h2, FIVE), A2)
    t = length & 15
    if t > 8:
        k2 = (words[4 * nblocks + 2], words[4 * nblocks + 3])
        h2 = _xor64(h2, _mix_k2(k2))
    if t > 0:
        k1 = (words[4 * nblocks], words[4 * nblocks + 1])
        h1 = _xor64(h1, _mix_k1(k1))
    ln = (np.uint32(length), np.uint32(0))
    h1 = _xor64(h1, ln)
    h2 = _xor64(h2, ln)
    h1 = _add64(h1, h2)
    h2 = _add64(h2, h1)
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = _add64(h1, h2)
    # h2 += h1 omitted; finch keeps only h1
    return h1


def packed2_to_u32_words(plo, phi, k: int):
    """Little-endian u32 words of the ASCII k-mer string for WIDE packed
    codes (32 <= k <= 63): plo holds bits [0, 64), phi bits [64, 2k), base
    0 most-significant. Every code's shift is even, so each code lives
    wholly in one u32 quarter."""
    quarters = [
        plo.astype(jnp.uint64).astype(U32),
        (plo.astype(jnp.uint64) >> jnp.uint64(32)).astype(U32),
        phi.astype(jnp.uint64).astype(U32),
        (phi.astype(jnp.uint64) >> jnp.uint64(32)).astype(U32),
    ]
    nwords = 2 * ((k + 7) // 8)
    words = []
    for w in range(nwords):
        acc = jnp.zeros_like(quarters[0])
        for j in range(w * 4, min(k, w * 4 + 4)):
            shift = 2 * (k - 1 - j)
            code = (quarters[shift // 32] >> U32(shift % 32)) & U32(3)
            byte = (_BASE_LUT >> (code << U32(3))) & U32(0xFF)
            acc = acc | (byte << U32(8 * (j - w * 4)))
        words.append(acc)
    return words


@partial(jax.jit, static_argnames=("k", "seed"))
def hash_packed_kmers_wide(plo, phi, *, k: int, seed: int = 0):
    """u64 hash lanes for wide two-word packed codes (32 <= k <= 63)."""
    if not 32 <= k <= 63:
        raise FinchMessageError("wide murmur path supports k in 32..=63")
    words = packed2_to_u32_words(plo, phi, k)
    lo, hi = murmur3_x64_u32_words(words, k, seed)
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def hash_packed_kmers_pair(packed, *, k: int, seed: int = 0):
    """(lo, hi) u32 hash lane pair for packed canonical k-mer codes."""
    if not 1 <= k <= 31:
        raise FinchMessageError("packed murmur path supports k in 1..=31")
    words = packed_to_u32_words(packed, k)
    return murmur3_x64_u32_words(words, k, seed)


@partial(jax.jit, static_argnames=("k", "seed"))
def hash_packed_kmers(packed, *, k: int, seed: int = 0):
    """u64 hash lanes for packed canonical k-mer codes (k <= 31)."""
    lo, hi = hash_packed_kmers_pair(packed, k=k, seed=seed)
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
