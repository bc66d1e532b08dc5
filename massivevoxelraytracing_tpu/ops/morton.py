"""Morton (Z-order) codes for 3x21-bit coordinates as (hi, lo) uint32 pairs.

The reference stores 63-bit Morton codes in uint64 with three interchangeable
codecs (naive loop, magic bits, BMI2 PDEP/PEXT) -- /root/reference/morton.hpp.
With JAX's x64 mode off and no PDEP, the layout here is a pair of uint32
limbs: lo holds interleaved bits 0..31 (coordinate bits 0..10 of
each axis, x at stride-3 offset 0), hi holds bits 32..62 (coordinate bits
11..20). Two codecs are provided, naive and magic-bits, mirroring the
reference's property-test strategy (unittest.cpp:183-216).

Magic-bit masks below were brute-force verified against the naive codec for
all 2^11 / 2^10 inputs (see tests/test_morton.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .bits import u32


def _c(x):
    return jnp.uint32(x)


MAX_COORD_BITS = 21


# -- magic-bit split/compact on uint32 limbs --------------------------------

def _part1by2_11(x):
    """Spread the low 11 bits of x to stride-3 positions 0,3,...,30."""
    x = u32(x) & _c(0x7FF)
    x = (x | (x << 16)) & _c(0x070000FF)
    x = (x | (x << 8)) & _c(0x0700F00F)
    x = (x | (x << 4)) & _c(0x430C30C3)
    x = (x | (x << 2)) & _c(0x49249249)
    return x


def _part1by2_10(x):
    """Spread the low 10 bits of x to stride-3 positions 0,3,...,27."""
    x = u32(x) & _c(0x3FF)
    x = (x | (x << 16)) & _c(0x030000FF)
    x = (x | (x << 8)) & _c(0x0300F00F)
    x = (x | (x << 4)) & _c(0x030C30C3)
    x = (x | (x << 2)) & _c(0x09249249)
    return x


def _compact1by2_11(x):
    """Inverse of _part1by2_11."""
    x = u32(x) & _c(0x49249249)
    x = (x ^ (x >> 2)) & _c(0x430C30C3)
    x = (x ^ (x >> 4)) & _c(0x0700F00F)
    x = (x ^ (x >> 8)) & _c(0x070000FF)
    x = (x ^ (x >> 16)) & _c(0x7FF)
    return x


def _compact1by2_10(x):
    """Inverse of _part1by2_10."""
    x = u32(x) & _c(0x09249249)
    x = (x ^ (x >> 2)) & _c(0x030C30C3)
    x = (x ^ (x >> 4)) & _c(0x0300F00F)
    x = (x ^ (x >> 8)) & _c(0x030000FF)
    x = (x ^ (x >> 16)) & _c(0x3FF)
    return x


def _split_by_3(x):
    """21-bit x -> 63-bit spread as (hi, lo): bits i of x land at 3i."""
    x = u32(x)
    lo = _part1by2_11(x & _c(0x7FF))
    hi = _part1by2_10(x >> 11) << 1  # coordinate bit 11 -> global bit 33 = hi bit 1
    return hi, lo


def encode_magicbits(x, y, z):
    """Interleave three 21-bit coords into a (hi, lo) Morton pair.

    Bit layout matches encode2mortonCode_magicbits (morton.hpp:111-116):
    x at stride-3 offset 0, y at offset 1, z at offset 2.
    """
    xh, xl = _split_by_3(x)
    yh, yl = _split_by_3(y)
    zh, zl = _split_by_3(z)
    # y << 1 and z << 2 across the 64-bit pair:
    yh = (yh << 1) | (yl >> 31)
    yl = yl << 1
    zh = (zh << 2) | (zl >> 30)
    zl = zl << 2
    return xh | yh | zh, xl | yl | zl


def decode_magicbits(hi, lo):
    """Inverse of encode_magicbits: (hi, lo) -> (x, y, z) uint32."""
    hi = u32(hi)
    lo = u32(lo)

    def axis(shift):
        # 64-bit right shift by `shift` (0, 1, 2), then take every third bit.
        if shift == 0:
            h, l = hi, lo
        else:
            l = (lo >> shift) | (hi << (32 - shift))
            h = hi >> shift
        c_lo = _compact1by2_11(l)  # coord bits 0..10
        c_hi = _compact1by2_10(h >> 1)  # global bit 33 -> coord bit 11
        return c_lo | (c_hi << 11)

    return axis(0), axis(1), axis(2)


def encode_naive(x, y, z):
    """Bit-loop codec, the test oracle (morton.hpp:5-16 behavior)."""
    x = u32(x)
    y = u32(y)
    z = u32(z)
    hi = jnp.zeros_like(x)
    lo = jnp.zeros_like(x)
    for i in range(MAX_COORD_BITS):
        for off, v in ((0, x), (1, y), (2, z)):
            pos = 3 * i + off
            bit = (v >> i) & _c(1)
            if pos < 32:
                lo = lo | (bit << pos)
            else:
                hi = hi | (bit << (pos - 32))
    return hi, lo


def decode_naive(hi, lo):
    hi = u32(hi)
    lo = u32(lo)
    x = jnp.zeros_like(lo)
    y = jnp.zeros_like(lo)
    z = jnp.zeros_like(lo)
    for i in range(MAX_COORD_BITS):
        for off, idx in ((0, 0), (1, 1), (2, 2)):
            pos = 3 * i + off
            if pos < 32:
                bit = (lo >> pos) & _c(1)
            else:
                bit = (hi >> (pos - 32)) & _c(1)
            if idx == 0:
                x = x | (bit << i)
            elif idx == 1:
                y = y | (bit << i)
            else:
                z = z | (bit << i)
    return x, y, z


# default codec
encode = encode_magicbits
decode = decode_magicbits


def morton_shr(hi, lo, n: int):
    """(hi, lo) >> n for a static shift amount (parent chains use n = 3k)."""
    if n == 0:
        return hi, lo
    if n < 32:
        return hi >> n, (lo >> n) | (hi << (32 - n))
    if n == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (n - 32)


def parent(hi, lo):
    """Morton code of the parent cell (morton >> 3), voxCommon.hpp:35."""
    return morton_shr(hi, lo, 3)


def child_slot(lo):
    """Low 3 bits: the child octant within the parent."""
    return u32(lo) & _c(7)


def number_of_sort_bits(grid_res: int) -> int:
    """3 * log2(gridRes) -- how many Morton bits are meaningful
    (voxCommon.hpp:113-118)."""
    assert grid_res > 0 and (grid_res & (grid_res - 1)) == 0, "gridRes must be pow2"
    return 3 * int(grid_res).bit_length() - 3


# -- numpy oracle (host-side, used by tests and CPU reference engines) ------

def np_encode(x, y, z):
    """uint64 Morton encode on host numpy (oracle)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    z = np.asarray(z, np.uint64)
    code = np.zeros_like(x)
    for i in range(MAX_COORD_BITS):
        code |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i)
        code |= ((y >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i + 1)
        code |= ((z >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i + 2)
    return code


def np_decode(code):
    code = np.asarray(code, np.uint64)
    x = np.zeros_like(code)
    y = np.zeros_like(code)
    z = np.zeros_like(code)
    for i in range(MAX_COORD_BITS):
        x |= ((code >> np.uint64(3 * i)) & np.uint64(1)) << np.uint64(i)
        y |= ((code >> np.uint64(3 * i + 1)) & np.uint64(1)) << np.uint64(i)
        z |= ((code >> np.uint64(3 * i + 2)) & np.uint64(1)) << np.uint64(i)
    return (
        x.astype(np.uint32),
        y.astype(np.uint32),
        z.astype(np.uint32),
    )


def np_pack_pair(code64):
    """uint64 -> (hi, lo) uint32 numpy pair."""
    code64 = np.asarray(code64, np.uint64)
    return (code64 >> np.uint64(32)).astype(np.uint32), (
        code64 & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


def np_unpack_pair(hi, lo):
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
