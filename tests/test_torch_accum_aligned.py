"""The aligned accumulate (``spgemm(accum=, accum_aligned=True)`` on
"rows": the row-panel path starts each slot from the accumulator's block)
in the port against the JAX package and against the port's generic
union accumulate, after tests/test_spgemm.py::test_accum_aligned_matches_generic.
The JAX package runs its row-panel kernel in interpret mode; the port
takes the kernel's plain version on the CPU.

The reference's planned aligned call checks only `accum.ids` against the
plan's accumulator ids, so a product block outside the accumulator is
dropped without a flag; the port also compares the plan's union with its
accumulator ids.  The cross-package comparisons cover only the cases
where the two packages agree."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import spgemm as jsp

from torch_port_helpers import assert_same_info, assert_same_matrix, to_port


def _aligned_case(b, nb=8, seed=5):
    """A random nb x nb block pattern at density 1/3 (the reference test's)
    and an accumulator D with exactly the support of A @ A."""
    rng = np.random.default_rng(seed)
    nblk = nb * nb // 3
    ids = np.sort(rng.choice(nb * nb, nblk, replace=False)).astype(np.int32)
    n = nb * b
    ja = jx.BlockMatrix(
        ids=jnp.asarray(ids),
        data=jnp.asarray(rng.standard_normal((nblk, b, b)).astype(np.float32)),
        nnz=jnp.asarray(nblk, jnp.int32), n_rows=n, n_cols=n, block_size=b,
    )
    pc, oc, mbr, mcr = jsp.plan_spgemm_ex(ja, ja)
    c0, _ = jx.spgemm(ja, ja, pair_cap=pc, out_cap=oc, backend="xla")
    jd = dataclasses.replace(c0, data=jnp.where(
        c0.valid_mask()[:, None, None],
        jnp.asarray(rng.standard_normal((oc, b, b)).astype(np.float32)), 0.0,
    ))
    return ja, to_port(ja), jd, to_port(jd), (pc, oc, (mbr, mcr))


@pytest.fixture(scope="module", params=[16, 128], ids=["b16", "b128"])
def case(request):
    return _aligned_case(request.param)


def _close(got, want):
    scale = float(np.abs(np.asarray(want.data)).max())
    assert_same_matrix(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("beta", [1.0, 0.5, "tensor"])
def test_aligned_matches_generic_and_jax(case, beta):
    ja, ta, jd, td, (pc, oc, rc) = case
    tbeta = torch.tensor(-0.75) if beta == "tensor" else beta
    jbeta = -0.75 if beta == "tensor" else beta
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows")
    generic, gi = tx.spgemm(ta, ta, accum=td, beta=tbeta, **kw)
    aligned, ai = tx.spgemm(ta, ta, accum=td, beta=tbeta, accum_aligned=True, **kw)
    assert not bool(ai.plan_mismatch)
    assert torch.equal(generic.ids, aligned.ids)
    # Products summed onto the loaded accumulator against beta*accum added
    # after the product sum: f32 rounding order.
    np.testing.assert_allclose(aligned.data.numpy(), generic.data.numpy(), rtol=2e-4, atol=1e-5)
    jc, ji = jx.spgemm(ja, ja, accum=jd, beta=jbeta, accum_aligned=True, **kw)
    _close(aligned, jc)
    assert_same_info(ai, ji)


def test_planned_equals_planless_bitwise(case):
    ja, ta, jd, td, (pc, oc, rc) = case
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows", accum=td,
              beta=0.5, accum_aligned=True)
    plan = tx.make_plan(ta, ta, pc, accum_ids=td.ids, out_cap=oc)
    c0, i0 = tx.spgemm(ta, ta, **kw)
    c1, i1 = tx.spgemm(ta, ta, plan=plan, **kw)
    assert torch.equal(c0.ids, c1.ids) and torch.equal(c0.data, c1.data)
    assert not bool(i0.plan_mismatch) and not bool(i1.plan_mismatch)
    jplan = jx.make_plan(ja, ja, pc, accum_ids=jd.ids, out_cap=oc)
    jc, ji = jx.spgemm(ja, ja, pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows",
                       accum=jd, beta=0.5, accum_aligned=True, plan=jplan)
    _close(c1, jc)
    assert_same_info(i1, ji)


def test_refused_without_rows_alpha_one_or_fitting_accum():
    _, ta, _, td, (pc, oc, rc) = _aligned_case(16, nb=4)
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, accum_aligned=True)
    with pytest.raises(ValueError, match="alpha == 1"):
        tx.spgemm(ta, ta, accum=td, alpha=2.0, backend="rows", **kw)
    for backend in ("xla", "pallas", "fine"):
        with pytest.raises(ValueError, match="rows backend"):
            tx.spgemm(ta, ta, accum=td, backend=backend, **kw)
    with pytest.raises(ValueError, match="requires accum"):
        tx.spgemm(ta, ta, backend="rows", **kw)
    with pytest.raises(ValueError, match="accum.cap == out_cap"):
        tx.spgemm(ta, ta, accum=tx.repack(td, oc + 1), backend="rows", **kw)


def _narrow(d, drop):
    """d without the valid block at slot `drop`, at d's capacity."""
    keep = torch.ones(d.cap, dtype=torch.bool)
    keep[drop] = False
    return tx.filter_blocks(d, keep)


def test_product_outside_accumulator_flagged():
    """An accumulator whose support misses a product block: planless, both
    packages flag it (membership search); planned, the port flags the plan
    whose union is wider than its accumulator ids."""
    ja, ta, jd, td, (pc, oc, rc) = _aligned_case(16)
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows", accum_aligned=True)
    narrow = _narrow(td, 1)
    _, i0 = tx.spgemm(ta, ta, accum=narrow, **kw)
    jn = jx.BlockMatrix(ids=jnp.asarray(narrow.ids.numpy()), data=jnp.asarray(narrow.data.numpy()),
                        nnz=jnp.asarray(int(narrow.nnz), jnp.int32), n_rows=ja.n_rows,
                        n_cols=ja.n_cols, block_size=ja.block_size)
    _, j0 = jx.spgemm(ja, ja, accum=jn, **kw)
    assert bool(i0.plan_mismatch) and bool(j0.plan_mismatch)
    plan = tx.make_plan(ta, ta, pc, accum_ids=narrow.ids, out_cap=oc)
    _, i1 = tx.spgemm(ta, ta, accum=narrow, plan=plan, **kw)
    assert bool(i1.plan_mismatch)
    # The plan of the full support stays clean.
    full = tx.make_plan(ta, ta, pc, accum_ids=td.ids, out_cap=oc)
    assert not bool(tx.spgemm(ta, ta, accum=td, plan=full, **kw)[1].plan_mismatch)


def test_duplicate_accumulator_ids_flagged():
    """tests/test_spgemm.py's duplicate-id target, in both packages."""
    ja, ta, jd, td, (pc, oc, rc) = _aligned_case(16)
    k = int(td.nnz)
    bad = td.ids.clone()
    bad[k - 1] = bad[k - 2]
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows", accum_aligned=True)
    _, ti = tx.spgemm(ta, ta, accum=dataclasses.replace(td, ids=bad), **kw)
    _, ji = jx.spgemm(ja, ja, accum=dataclasses.replace(jd, ids=jnp.asarray(bad.numpy())), **kw)
    assert bool(ti.plan_mismatch) and bool(ji.plan_mismatch)


def test_aligned_with_norm_filter_matches_jax():
    """SpAMM into an aligned accumulator (both options on the row-panel
    path): the skipped products leave their slots at beta*D."""
    ja, ta, jd, td, (pc, oc, rc) = _aligned_case(16, seed=6)
    an = np.sqrt(tx.block_frob_squared(ta).numpy()[: int(ta.nnz)])
    prods = np.sort(np.outer(an, an).ravel())
    m = len(prods) // 2
    assert prods[m] > prods[m - 1] * (1 + 1e-5)
    tau = float(0.5 * (prods[m] + prods[m - 1]))
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows", accum_aligned=True,
              beta=2.0, tau=tau, filter_by_norm=True)
    tc, ti = tx.spgemm(ta, ta, accum=td, **kw)
    jc, ji = jx.spgemm(ja, ja, accum=jd, **kw)
    _close(tc, jc)
    assert_same_info(ti, ji)
    assert 0 < int(ti.n_block_pairs) < pc
