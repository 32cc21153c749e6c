"""Morton (Z-order) codes: the pointer-free quadtree (port of
``core/morton.py``).

A quadtree node at level ``l`` (root = level 0) over a ``2^d x 2^d``
block grid is the set of blocks whose Morton code shares its top ``2*l``
bits, so subtree aggregation is a segment reduction keyed on
``code >> (2*(d-l))``.  Codes are int32 tensors, as in the JAX package;
the bit spreading runs in int64 on the low 32 bits, which gives the
reference's uint32 arithmetic (torch has few uint32 kernels).
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as int32 (two's complement)."""
    v = v & _LOW32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def interleave_bits(x: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Spread the low `bits` bits of x so consecutive bits land 2 apart
    (magic-number spreading; int32 in and out; bits <= 16)."""
    del bits
    v = x.to(torch.int64) & _LOW32
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v.to(torch.int32)


def encode(brow: torch.Tensor, bcol: torch.Tensor) -> torch.Tensor:
    """Morton code with row bits in odd positions, col bits in even."""
    row = interleave_bits(brow).to(torch.int64) << 1
    return _to_int32(row | interleave_bits(bcol).to(torch.int64))


def deinterleave_bits(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64) & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v.to(torch.int32)


def decode(code: torch.Tensor):
    """Inverse of `encode`: returns (brow, bcol)."""
    code = code.to(torch.int32)
    return deinterleave_bits(code >> 1), deinterleave_bits(code)


def subtree_key(code: torch.Tensor, depth: int, level: int) -> torch.Tensor:
    """Quadtree-node key at `level` for blocks of a depth-`depth` tree.

    depth = ceil(log2(nb)), the leaf level; level 0 is the root (key 0
    for all), level == depth one key per block.
    """
    return code.to(torch.int32) >> (2 * (depth - level))
