"""Hierarchical block-sparse linear algebra in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``hierarchical_block_sparse_lib_tpu`` (the JAX package, which
stays the reference).  Module paths and public names mirror the JAX
package's, so ``import hierarchical_block_sparse_lib_tpu_torch as hbsm``
reads like its quick start.  Matrices are frozen dataclasses of tensors;
operations are plain functions on tensors, on the tensors' device.  This
package imports torch and numpy, never jax.

Ported so far: the fine-leaf chain (``fine_pack`` -> ``make_fine_plan``
-> ``fine_matmul`` -> ``fine_add``/``fine_scale`` -> ``fine_unpack``) and
what it stands on, with the Hopper kernel of
``kernels/pallas_gemm_fine.py::fine_spgemm``.
"""

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.core.assembly import (
    empty,
    from_coo,
    from_dense,
    to_dense,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.basic import (
    add,
    add_with_info,
    scale,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import (
    block_frob_squared,
    frob_squared,
    trace,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    MultiplyInfo,
    spgemm_symbolic,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.fine import (
    FineFlat,
    FinePlan,
    fine_add,
    fine_frob_squared,
    fine_matmul,
    fine_pack,
    fine_scale,
    fine_sp2_step,
    fine_trace,
    fine_truncate,
    fine_unpack,
    make_fine_plan,
)

__all__ = [
    "BlockMatrix",
    "SENTINEL",
    "from_coo",
    "from_dense",
    "to_dense",
    "empty",
    "add",
    "add_with_info",
    "scale",
    "frob_squared",
    "block_frob_squared",
    "trace",
    "truncate",
    "spgemm_symbolic",
    "MultiplyInfo",
    "FineFlat",
    "FinePlan",
    "make_fine_plan",
    "fine_pack",
    "fine_unpack",
    "fine_matmul",
    "fine_add",
    "fine_scale",
    "fine_truncate",
    "fine_trace",
    "fine_sp2_step",
    "fine_frob_squared",
]

__version__ = "0.1.0"
