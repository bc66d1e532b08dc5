"""Bit-twiddling primitives on uint32, plus 64-bit arithmetic as 2x uint32 limbs.

JAX keeps x64 disabled by default, so every 64-bit quantity in this framework (Morton
codes, PCG32 state) is carried as a (hi, lo) pair of uint32 arrays. All
helpers are shape-polymorphic and jit/vmap friendly.

Reference behaviors re-implemented here (cited for parity, not copied):
  - reverseBits / laine_karras_permutation / nested_uniform_scramble /
    scramble_f32: /root/reference/pmjSampler.hpp:62-102
  - uniformf: /root/reference/renderCommon.hpp:112-117
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32

UINT32_MAX = 0xFFFFFFFF


def u32(x):
    return jnp.asarray(x, U32)


def _c(x):  # uint32 constant
    return jnp.uint32(x)


# ---------------------------------------------------------------------------
# Single-word bit tricks
# ---------------------------------------------------------------------------

def reverse_bits(v):
    """Bit-reverse a uint32 (classic swap ladder)."""
    v = u32(v)
    v = ((v >> 1) & _c(0x55555555)) | ((v & _c(0x55555555)) << 1)
    v = ((v >> 2) & _c(0x33333333)) | ((v & _c(0x33333333)) << 2)
    v = ((v >> 4) & _c(0x0F0F0F0F)) | ((v & _c(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & _c(0x00FF00FF)) | ((v & _c(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    return v


def laine_karras_permutation(x, seed):
    x = u32(x) + u32(seed)
    x = x ^ (x * _c(0x6C50B47C))
    x = x ^ (x * _c(0xB82F1E52))
    x = x ^ (x * _c(0xC7AFE638))
    x = x ^ (x * _c(0x8D22F6E6))
    return x


def nested_uniform_scramble(x, seed):
    """Owen scrambling of an index: reverse o laine_karras o reverse."""
    return reverse_bits(laine_karras_permutation(reverse_bits(x), seed))


def uniformf(x):
    """uint32 -> float in [0, 1) via mantissa stuffing."""
    bits = (u32(x) >> 9) | _c(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, F32) - 1.0


def scramble_f32(x, seed):
    """Owen-scramble the mantissa of a float in [0, 1)."""
    y = jnp.asarray(x, F32) + 1.0  # [1, 2)
    bits = jax.lax.bitcast_convert_type(y, U32)
    scrambled = _c(0x3F800000) | (
        nested_uniform_scramble(bits & _c(0x7FFFFF), seed) & _c(0x7FFFFF)
    )
    return jax.lax.bitcast_convert_type(scrambled, F32) - 1.0


def popcount32(v):
    """Population count of a uint32."""
    v = u32(v)
    v = v - ((v >> 1) & _c(0x55555555))
    v = (v & _c(0x33333333)) + ((v >> 2) & _c(0x33333333))
    v = (v + (v >> 4)) & _c(0x0F0F0F0F)
    return (v * _c(0x01010101)) >> 24


def popcount8(v):
    """Population count of the low 8 bits of a uint32."""
    v = u32(v) & _c(0xFF)
    v = (v & _c(0x55)) + ((v >> 1) & _c(0x55))
    v = (v & _c(0x33)) + ((v >> 2) & _c(0x33))
    v = (v & _c(0x0F)) + ((v >> 4) & _c(0x0F))
    return v


# ---------------------------------------------------------------------------
# 64-bit arithmetic on (hi, lo) uint32 pairs
# ---------------------------------------------------------------------------

def umul32_wide(a, b):
    """32x32 -> 64 multiply, returns (hi, lo) uint32."""
    a = u32(a)
    b = u32(b)
    a_lo = a & _c(0xFFFF)
    a_hi = a >> 16
    b_lo = b & _c(0xFFFF)
    b_hi = b >> 16

    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi

    # lo = ll + ((lh + hl) << 16), tracking carries.
    mid = lh + (ll >> 16)
    mid2 = (mid & _c(0xFFFF)) + hl
    lo = (mid2 << 16) | (ll & _c(0xFFFF))
    hi = hh + (mid >> 16) + (mid2 >> 16)
    return hi, lo


def add64(a, b):
    """(hi, lo) + (hi, lo) with carry, wrapping at 2**64."""
    ahi, alo = a
    bhi, blo = b
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    hi = ahi + bhi + carry
    return hi, lo


def mul64(a, b):
    """(hi, lo) * (hi, lo) mod 2**64."""
    ahi, alo = a
    bhi, blo = b
    hi, lo = umul32_wide(alo, blo)
    hi = hi + alo * bhi + ahi * blo
    return hi, lo


def shr64(a, n: int):
    """Logical right shift of (hi, lo) by a static amount 0..63."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        return hi >> n, (lo >> n) | (hi << (32 - n))
    if n == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (n - 32)


def shl64(a, n: int):
    """Left shift of (hi, lo) by a static amount 0..63."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        return (hi << n) | (lo >> (32 - n)), lo << n
    if n == 32:
        return lo, jnp.zeros_like(lo)
    return lo << (n - 32), jnp.zeros_like(lo)


def shr64_dyn(a, n):
    """Logical right shift of (hi, lo) by a traced amount 0..63."""
    hi, lo = a
    n = jnp.asarray(n, U32)
    small = n < 32
    ns = jnp.where(small, n, n - 32)
    # n == 0 would make (32 - n) == 32 which is UB for u32 shifts; guard it.
    hi_into_lo = jnp.where(ns == 0, jnp.zeros_like(hi), hi << (32 - ns))
    lo_small = (lo >> ns) | hi_into_lo
    hi_small = hi >> ns
    lo_big = hi >> ns
    return jnp.where(small, hi_small, jnp.zeros_like(hi)), jnp.where(
        small, lo_small, lo_big
    )


def eq64(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def lt64(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def mod64_u32(a, n):
    """(hi, lo) mod n for uint32 n, via 32 steps of shift-and-subtract.

    Cold path (used only by the LCG shuffler parity port,
    /root/reference/renderCommon.hpp:500-502).
    """
    hi, lo = a
    n = u32(n)
    r = hi % n

    def body(i, r):
        bit = (lo >> (_c(31) - u32(i))) & _c(1)
        # r < n <= 2^32-1. Compute (r*2 + bit) mod n without overflow:
        # if r >= 2^31 the shift overflows, but then r*2+bit-n fits since n>r.
        overflow = r >= _c(0x80000000)
        r2 = (r << 1) | bit
        r2 = jnp.where(overflow, r2 - n, r2)  # wrapped value + 2^32 - n... see note
        # note: (r*2+bit) - n computed in wrapping arithmetic equals the true
        # value minus n exactly when overflow happened (true value < 2n).
        r2 = jnp.where(r2 >= n, r2 - n, r2)
        return r2

    return jax.lax.fori_loop(0, 32, body, r)
