"""Hierarchical block-sparse linear algebra in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``hierarchical_block_sparse_lib_tpu`` (the JAX package, which
stays the reference).  Module paths and public names mirror the JAX
package's, so ``import hierarchical_block_sparse_lib_tpu_torch as hbsm``
reads like its quick start.  Matrices are frozen dataclasses of tensors;
operations are plain functions on tensors, on the tensors' device.  This
package imports torch and numpy, never jax.

Ported so far: the fine-leaf chain (``fine_pack`` -> ``make_fine_plan``
-> ``fine_matmul`` -> ``fine_add``/``fine_scale`` -> ``fine_unpack``) on
the Hopper kernel of ``kernels/pallas_gemm_fine.py::fine_spgemm``; SP2
purification (``profile_purify`` -> ``plan_purify`` -> ``purify_scan``,
``PurifyEngine`` and ``purify``, over ``spgemm`` and ``truncate``) at
128-wide leaves on the kernels of ``kernels/pallas_gemm_rows.py::rows_spgemm``,
``kernels/pallas_gemm_stream.py`` and ``kernels/pallas_norms.py``, and at
16/32/64-wide leaves on the fine kernel; and
the eager ``matmul`` with ``plan_groups`` on the row-group kernel of
``kernels/pallas_gemm_groups.py``; and the occupancy tiers, whose dense
products are batched `torch.bmm`: the column-slab tier ``spgemm_colslab``
(each slab on the row-panel kernel), the dense band (``BandMatrix``,
``band_*``), leaf-strip packing (``plan_leafpack``/``leafpack_spgemm``),
contraction packing (``plan_kpack``/``kpack_spgemm``) and ``spmm``/``spmv``;
the reference-shaped surface: the class ``HierarchicalBlockSparseMatrix``
with ``Params``, COO export (``to_coo``, ``to_coo_chunks``,
``get_values``) and npz files (``save``/``load``, the JAX package's
format); and the symmetric product: ``syrk``/``plan_syrk`` (upper-triangle
products on the row-panel kernel's ``triu`` skip), ``triu``/``tril``/
``filter_blocks`` and symmetric SP2 (``symmetric=True``); the
error-controlled multiply ``spamm`` (``plan_spamm``; the row-panel
kernel's norm skip), the aligned accumulate, the planned add
(``make_add_plan``/``add_planned``), the model drivers ``polynomial``,
``chebyshev_apply`` and ``inv_sqrt_newton_schulz`` with their plans
(``models``; Newton-Schulz also through ``profile_inv_sqrt`` and
``InvSqrtEngine``), and the norms ``frob_norm``, ``nnz_blocks``,
``gershgorin_bound`` and ``subtree_frob_squared`` with subtree
``truncate``; and the distribution (``parallel``): a single-process mesh
of torch devices (``parallel.mesh``) with ring SUMMA (``dist``), Cannon
(``dist2d``), the routed and two-level block routers and routed SP2
(``route``, ``route2``), and ``entry.dryrun_multichip``.
Constructors build on the CUDA card unless given another ``device``.
"""

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    Params,
)
from hierarchical_block_sparse_lib_tpu_torch.core.assembly import (
    empty,
    eye,
    from_coo,
    from_dense,
    get_values,
    to_coo,
    to_coo_chunks,
    to_dense,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.basic import (
    AddPlan,
    add,
    add_planned,
    add_with_info,
    filter_blocks,
    make_add_plan,
    scale,
    transpose,
    tril,
    triu,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import (
    block_frob_squared,
    frob_norm,
    frob_squared,
    gershgorin_bound,
    nnz_blocks,
    subtree_frob_squared,
    trace,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    MultiplyInfo,
    SymbolicPlan,
    make_plan,
    plan_spamm,
    plan_syrk,
    spamm,
    spgemm,
    spgemm_symbolic,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.matmul import matmul, syrk
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_groups import (
    GroupPlan,
    plan_groups,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.repack import (
    coarsen,
    plan_coarsen,
    repack,
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
from hierarchical_block_sparse_lib_tpu_torch.ops.band import (
    BandMatrix,
    band_add,
    band_frob_squared,
    band_from_blocks,
    band_from_dense,
    band_mm,
    band_probe,
    band_scale,
    band_to_blocks,
    band_to_dense,
    band_trace,
    band_transpose,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.kpack import (
    KpackPlan,
    kpack_spgemm,
    plan_kpack,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.leafpack import (
    LeafpackPlan,
    leafpack_spgemm,
    plan_leafpack,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.slab import spgemm_colslab
from hierarchical_block_sparse_lib_tpu_torch.ops.spmm import spmm, spmv
from hierarchical_block_sparse_lib_tpu_torch.models.purification import (
    CapacityProfile,
    PurificationStats,
    PurifyEngine,
    PurifyPlans,
    plan_purify,
    profile_purify,
    purify,
    purify_scan,
    sp2_step,
)
from hierarchical_block_sparse_lib_tpu_torch.models.inverse_factor import (
    InvSqrtEngine,
    profile_inv_sqrt,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.serialization import load, save
from hierarchical_block_sparse_lib_tpu_torch.api import HierarchicalBlockSparseMatrix

__all__ = [
    "BlockMatrix",
    "Params",
    "SENTINEL",
    "from_coo",
    "from_dense",
    "to_dense",
    "to_coo",
    "to_coo_chunks",
    "get_values",
    "empty",
    "eye",
    "add",
    "AddPlan",
    "add_planned",
    "add_with_info",
    "make_add_plan",
    "scale",
    "transpose",
    "filter_blocks",
    "triu",
    "tril",
    "frob_squared",
    "frob_norm",
    "block_frob_squared",
    "trace",
    "nnz_blocks",
    "subtree_frob_squared",
    "gershgorin_bound",
    "truncate",
    "spgemm",
    "spgemm_symbolic",
    "spamm",
    "plan_spamm",
    "make_plan",
    "SymbolicPlan",
    "MultiplyInfo",
    "matmul",
    "syrk",
    "plan_syrk",
    "plan_groups",
    "GroupPlan",
    "repack",
    "coarsen",
    "plan_coarsen",
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
    "CapacityProfile",
    "PurificationStats",
    "PurifyEngine",
    "PurifyPlans",
    "plan_purify",
    "profile_purify",
    "purify",
    "purify_scan",
    "sp2_step",
    "InvSqrtEngine",
    "profile_inv_sqrt",
    "BandMatrix",
    "band_from_blocks",
    "band_from_dense",
    "band_to_dense",
    "band_to_blocks",
    "band_mm",
    "band_add",
    "band_scale",
    "band_frob_squared",
    "band_trace",
    "band_transpose",
    "band_probe",
    "LeafpackPlan",
    "plan_leafpack",
    "leafpack_spgemm",
    "KpackPlan",
    "plan_kpack",
    "kpack_spgemm",
    "spgemm_colslab",
    "spmm",
    "spmv",
    "save",
    "load",
    "HierarchicalBlockSparseMatrix",
]

__version__ = "0.1.0"
