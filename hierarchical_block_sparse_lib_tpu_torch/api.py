"""Reference-shaped object API: ``HierarchicalBlockSparseMatrix`` (port of
``api.py``).

A stateful wrapper over the functional core with the reference's method
names (``set_params``/``get_params``, ``resize``,
``assign_from_vectors``, ``get_values``/``get_all_values``,
``add``/``multiply``/``rescale``/``get_transpose``,
``get_frob_squared``/``get_trace``/``get_nnz``, ``frob_block_trunc``),
so a user of the reference can migrate method by method.  Each call is
eager and exact: capacities come from the host planner, and `multiply`
reuses a structure-keyed plan cache, so multiplies at a fixed structure
run the numeric phase only.

A matrix lives on one device: the card unless the constructor's `device`
names another (`resolve_device`); `multiply`, `add` and `get_transpose`
build their results on the operands' device.  Host-facing reads
(`get_values`, `get_all_values`, `to_dense`) return numpy arrays, as the
reference's do (bfloat16 widened to float32, which numpy has).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    BlockMatrix,
    Params,
    resolve_device,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import band as band_ops
from hierarchical_block_sparse_lib_tpu_torch.ops import basic, norms
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    make_plan,
    plan_spgemm_ex,
    spgemm,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.runtime import native


def _clone(m):
    """A BlockMatrix or BandMatrix with its tensors cloned (None stays)."""
    if m is None:
        return None
    return dataclasses.replace(m, **{
        f.name: getattr(m, f.name).clone()
        for f in dataclasses.fields(m) if isinstance(getattr(m, f.name), torch.Tensor)
    })


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16, which numpy lacks, is
    widened to float32 (exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def band_block_halfwidth(w: int, block_size: int) -> int:
    """Block halfwidth of an element halfwidth `w`: ceil((w+1)/b) - 1.
    `band_probe` returns w = wb*b + b - 1 for a matrix whose blocks reach
    wb block diagonals off the main one, and this gives back wb."""
    return -(-(w + 1) // block_size) - 1


class HierarchicalBlockSparseMatrix:
    """Stateful block-sparse matrix with the reference's method names."""

    def __init__(self, params: Params | None = None, device=None):
        self._params = params or Params()
        self._device = resolve_device(device)
        self._m: BlockMatrix | None = None
        # Band residency: when the structure probes as a dense band,
        # multiply and rescale keep the strip-panel form (`ops.band`) alive
        # across calls, and the block form is materialized on demand.
        # `_band_w` caches the probe of `_m` (None: declined; -1: not
        # probed yet).
        self._band = None
        self._band_w: int | None = -1
        # The reference's instrumentation counters.
        self.no_of_block_multiplies = 0
        self.no_of_resizes = 0

    @property
    def device(self) -> torch.device:
        return self._device

    # -- params / geometry -----------------------------------------------
    def set_params(self, params: Params) -> None:
        if self._m is not None:
            raise RuntimeError("set_params must precede resize/assign")
        self._params = params

    def get_params(self) -> Params:
        return self._params

    def resize(self, n_rows: int, n_cols: int | None = None) -> None:
        n_cols = n_rows if n_cols is None else n_cols
        self._m = assembly.empty(
            n_rows, n_cols, self._params.block_size, cap=1,
            dtype=self._params.dtype, device=self._device,
        )
        self._band = None
        self._band_w = -1
        self.no_of_resizes += 1

    def clear(self) -> None:
        self._m = None
        self._band = None
        self._band_w = -1

    def empty(self) -> bool:
        """True when nothing is stored.  A band-resident matrix answers from
        the band side without materializing: its block form holds every
        block of the band support, which is empty only at order 0."""
        if self._m is None and self._band is None:
            return True
        if self._m is None:
            return self._band.n == 0
        return int(self._m.nnz) == 0

    def get_n_rows(self) -> int:
        self._require()
        return self._band.n if self._m is None else self._m.n_rows

    def get_n_cols(self) -> int:
        self._require()
        return self._band.n if self._m is None else self._m.n_cols

    def get_depth(self) -> int:
        """Depth of the implicit quadtree: ceil(log2(blocks per side))."""
        b = self._params.block_size
        nb = max(-(-self.get_n_rows() // b), -(-self.get_n_cols() // b))
        return max(int(nb - 1).bit_length(), 0)

    # -- assembly / extraction -------------------------------------------
    def assign_from_vectors(self, rows, cols, values) -> None:
        self._require()
        n_rows, n_cols = self.get_n_rows(), self.get_n_cols()
        b = self._params.block_size
        rows, cols = np.asarray(rows), np.asarray(cols)
        cap = max(native.count_coo_blocks(rows, cols, b, -(-n_cols // b)), 1)
        vals = torch.as_tensor(np.asarray(values)).to(self._params.dtype)
        self._band = None
        self._band_w = -1
        self._m = assembly.from_coo(
            rows, cols, vals, n_rows, n_cols, block_size=b, cap=cap, device=self._device,
        )

    def get_values(self, rows, cols) -> np.ndarray:
        self._require()
        return _host(assembly.get_values(self._mat(), rows, cols))

    def get_all_values(self):
        """(rows, cols, values) of all stored elements (explicit zeros in
        stored blocks excluded, as a sparse export).  Streams to the host
        in bounded windows, then concatenates them, so peak host memory
        is about twice the result, not four cap*b*b arrays."""
        self._require()
        chunks = list(assembly.to_coo_chunks(self._mat(), drop_zeros=True))
        if not chunks:
            dt = _host(torch.empty(0, dtype=self._params.dtype)).dtype
            return np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, dt)
        rs, cs, vs = zip(*chunks)
        return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)

    def to_dense(self) -> np.ndarray:
        self._require()
        return _host(assembly.to_dense(self._mat()))

    # -- algebra ------------------------------------------------------------

    # Structure-keyed plan cache: repeated multiplies at one structure
    # (stencils, SCF iterations) run the numeric phase only.  Keyed by the
    # operands' exact id bytes, geometry, device and dtype, so a hit is
    # valid (spgemm's plan_mismatch self-check confirms it) and a plan
    # built on one device never serves a call on another.  Bounded LRU,
    # shared by every instance.  For whole purification loops prefer
    # `models.purification.PurifyEngine`.
    _PLAN_CACHE_MAX = 8
    _plan_cache: OrderedDict = OrderedDict()

    @classmethod
    def _cached_plan(cls, am: BlockMatrix, bm: BlockMatrix):
        key = (
            am.ids.cpu().numpy().tobytes(), bm.ids.cpu().numpy().tobytes(),
            am.n_rows, am.n_cols, bm.n_rows, bm.n_cols, am.block_size,
            str(am.device), am.dtype,
        )
        hit = cls._plan_cache.pop(key, None)
        if hit is None:
            pc, oc, mbr, mcr = plan_spgemm_ex(am, bm)
            plan = make_plan(am, bm, max(pc, 1))
            hit = (plan, max(pc, 1), max(oc, 1), (mbr, mcr))
        cls._plan_cache[key] = hit  # re-insert: LRU order
        while len(cls._plan_cache) > cls._PLAN_CACHE_MAX:
            cls._plan_cache.popitem(last=False)
        return hit

    def _like(self) -> "HierarchicalBlockSparseMatrix":
        """An unset matrix with this one's params, on its device."""
        return HierarchicalBlockSparseMatrix(self._params, device=self._device)

    @staticmethod
    def multiply(
        a: "HierarchicalBlockSparseMatrix",
        transpose_a: bool,
        b: "HierarchicalBlockSparseMatrix",
        transpose_b: bool,
        alpha: float = 1.0,
    ) -> "HierarchicalBlockSparseMatrix":
        """C = alpha * op(A) op(B), the reference's multiply with transpose
        flags; counters accumulate on C.

        When both operands probe as dense bands the band tier runs and C
        stays band-resident (it is never re-probed: a band product is kept
        in band form whatever its fill).  Its counter adds the structural
        pair count of the operands' band support (`band_pair_count` at
        block halfwidth ceil((w+1)/b) - 1), which equals the block path's
        pair count for bands whose blocks are all stored.  Otherwise the
        block path runs with a cached frozen plan; C's counter is A's
        count plus this multiply's pairs (a left-to-right chain
        ((A@B)@C)@... carries its running count in `a`; B's is not added,
        which would count shared history twice in multiply(X, X))."""
        a._require()
        b._require()
        if a._ensure_band() and b._ensure_band() and a._band.n == b._band.n:
            ab = band_ops.band_transpose(a._band) if transpose_a else a._band
            bb = band_ops.band_transpose(b._band) if transpose_b else b._band
            cb = band_ops.band_mm(ab, bb)
            if not (isinstance(alpha, (int, float)) and alpha == 1.0):
                cb = band_ops.band_scale(cb, alpha)
            c = a._like()
            c._band = cb
            c._band_w = cb.w
            bsz = a._params.block_size
            nb = -(-cb.n // bsz)
            k = np.arange(nb)
            cnt = []
            for w in (ab.w, bb.w):
                wb = band_block_halfwidth(w, bsz)
                cnt.append(np.minimum(nb - 1, k + wb) - np.maximum(0, k - wb) + 1)
            c.no_of_block_multiplies = a.no_of_block_multiplies + int((cnt[0] * cnt[1]).sum())
            return c
        am = basic.transpose(a._mat()) if transpose_a else a._mat()
        bm = basic.transpose(b._mat()) if transpose_b else b._mat()
        plan, pc, oc, row_caps = HierarchicalBlockSparseMatrix._cached_plan(am, bm)
        cm, info = spgemm(
            am, bm, pair_cap=pc, out_cap=oc, alpha=alpha, row_caps=row_caps, plan=plan,
        )
        if bool(info.plan_mismatch):
            raise AssertionError("plan cache returned a stale plan (key collision?)")
        c = a._like()
        c._m = cm
        c.no_of_block_multiplies = a.no_of_block_multiplies + int(info.n_block_pairs)
        return c

    @staticmethod
    def add(
        a: "HierarchicalBlockSparseMatrix",
        b: "HierarchicalBlockSparseMatrix",
        alpha: float = 1.0,
        beta: float = 1.0,
    ) -> "HierarchicalBlockSparseMatrix":
        a._require()
        b._require()
        am, bm = a._mat(), b._mat()
        cap = native.plan_add(am.ids.cpu().numpy(), bm.ids.cpu().numpy())
        c = a._like()
        c._m = basic.add(am, bm, alpha=alpha, beta=beta, cap=max(cap, 1))
        return c

    def rescale(self, alpha: float) -> None:
        self._require()
        if self._band is not None:
            self._band = band_ops.band_scale(self._band, alpha)
        if self._m is not None:
            self._m = basic.scale(self._m, alpha)

    def get_transpose(self) -> "HierarchicalBlockSparseMatrix":
        self._require()
        t = self._like()
        t._m = basic.transpose(self._mat())
        return t

    # -- norms / counters ---------------------------------------------------
    def get_frob_squared(self) -> float:
        self._require()
        if self._m is None:
            return float(band_ops.band_frob_squared(self._band))
        return float(norms.frob_squared(self._m))

    def get_trace(self) -> float:
        self._require()
        if self._m is None:
            return float(band_ops.band_trace(self._band))
        return float(norms.trace(self._m))

    def get_nnz(self) -> int:
        """Stored elements (nnz blocks * block area), the reference's
        storage counter."""
        return self.get_nnz_blocks() * self._params.block_size**2

    def get_nnz_blocks(self) -> int:
        self._require()
        return int(self._mat().nnz)

    # -- truncation -----------------------------------------------------------
    def frob_block_trunc(self, tau: float) -> None:
        """Drop blocks with Frobenius norm <= tau (in place)."""
        self._require()
        self._m = truncate(self._mat(), tau)
        self._band = None
        self._band_w = -1

    # -- copy -------------------------------------------------------------
    def copy(self) -> "HierarchicalBlockSparseMatrix":
        """A deep copy: the tensors are cloned, so nothing done to one
        matrix in place reaches the other."""
        c = self._like()
        c._m = _clone(self._m)
        c._band = _clone(self._band)
        c._band_w = self._band_w
        c.no_of_block_multiplies = self.no_of_block_multiplies
        c.no_of_resizes = self.no_of_resizes
        return c

    # -- interop ----------------------------------------------------------------
    @property
    def block_matrix(self) -> BlockMatrix:
        """The underlying functional-core value."""
        self._require()
        return self._mat()

    @classmethod
    def from_block_matrix(cls, m: BlockMatrix) -> "HierarchicalBlockSparseMatrix":
        """Wrap `m` (shared, not copied) on its own device."""
        obj = cls(Params(m.block_size, m.dtype), device=m.device)
        obj._m = m
        return obj

    def _mat(self) -> BlockMatrix:
        """The block form, materialized from a band-resident state if need
        be (band_to_blocks emits the whole band support, so the storage
        counters then count the band support)."""
        if self._m is None and self._band is not None:
            self._m = band_ops.band_to_blocks(self._band, block_size=self._params.block_size)
        return self._m

    def _ensure_band(self) -> bool:
        """True when this matrix is, or can become, band-resident: probe
        once per structure, pack once per data (both cached)."""
        if self._band is not None:
            return True
        if self._band_w == -1:
            self._band_w = band_ops.band_probe(self._m)
        if self._band_w is None:
            return False
        self._band = band_ops.band_from_blocks(self._m, self._band_w)
        return True

    def _require(self):
        if self._m is None and self._band is None:
            raise RuntimeError("matrix is empty: call resize() first")

    def __repr__(self):  # pragma: no cover - debug aid
        if self._m is None and self._band is None:
            return "HierarchicalBlockSparseMatrix(<unset>)"
        return f"HierarchicalBlockSparseMatrix({self._m if self._m is not None else self._band!r})"
