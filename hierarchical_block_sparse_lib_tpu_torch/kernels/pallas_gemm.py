"""The v1 gather-GEMM-accumulate, served by the pair-stream kernel.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm.py::
gather_gemm_accumulate`` (the TPU kernel `_call_one_chunk`) and keeps its
contract: ``out[seg[p]] += A[a_idx[p]] @ B[b_idx[p]]`` over c-sorted pairs,
f32 out, the pair list cut into chunks of `chunk` pairs (`PAIR_CHUNK`, the
TPU's SMEM budget), each chunk accumulating onto the carried output, so a
segment that spans a chunk boundary sums exactly.  Each chunk is one launch
of ``kernels/csrc/gemm_stream.cu`` with the carried output as its `cin`;
there is no second CUDA kernel.  Slots that no pair reaches are zero, or
the caller's `cin` block.

`gather_gemm_accumulate.launches` counts calls that ran on the card; the
stream kernel's own count (`pallas_gemm_stream.gather_gemm_accumulate_
stream.launches`) counts its launches, one per chunk.
"""

from __future__ import annotations

import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream

PAIR_CHUNK = 24576


def gather_gemm_accumulate(
    a_data: torch.Tensor,  # [capA, b, b]
    b_data: torch.Tensor,  # [capB, b, b]
    a_idx: torch.Tensor,  # int[pairs]
    b_idx: torch.Tensor,  # int[pairs]
    seg: torch.Tensor,  # int[pairs], sorted; >= out_cap for pairs with no slot
    out_cap: int,
    precision: str = "highest",
    chunk: int = PAIR_CHUNK,
    cin: torch.Tensor | None = None,  # f32[out_cap, b, b] starting values
) -> torch.Tensor:
    """f32[out_cap, b, b] segment-accumulated block products, computed in
    chunks of `chunk` pairs; equal to one call over all pairs."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    pairs = a_idx.shape[0]
    out = cin
    for s0 in range(0, max(pairs, 1), chunk):
        sl = slice(s0, s0 + chunk)
        out = pallas_gemm_stream.gather_gemm_accumulate_stream(
            a_data, b_data, a_idx[sl], b_idx[sl], seg[sl], out_cap,
            precision=precision, cin=out,
        )
    if a_data.device.type == "cuda":
        gather_gemm_accumulate.launches += 1
    return out


gather_gemm_accumulate.launches = 0


def gather_gemm_accumulate_reference(
    a_data, b_data, a_idx, b_idx, seg, out_cap: int, precision: str = "highest",
    chunk: int = PAIR_CHUNK, cin=None,
) -> torch.Tensor:
    """The plain PyTorch version (same arguments), on any device: one
    gather + `bmm` + `index_add_` over all pairs."""
    del chunk
    return pallas_gemm_stream.gather_gemm_accumulate_stream_reference(
        a_data, b_data, a_idx, b_idx, seg, out_cap, precision, cin=cin
    )
