"""spgemm's fine-branch output pass (kernels/fine_epilogue.py; on the CPU its
plain version) against the passes it replaced (`former_fine_output.py`):
D bit for bit, signed zeros included, at leaves 16, 32 and 64, with alpha
and beta as numbers and as 0-dim tensors, an accumulator absent, disjoint
from the product, overlapping it, equal to it, or an empty union, the
union's SENTINEL tail, planned and unplanned; and a planned SP2 scan of
the water-cluster deployment cut to 64 molecules through both."""

import dataclasses
import os

import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as tx
from benchmark import harness
from benchmark.reference import sp2 as ref_sp2
from benchmark.systems import sp2 as sys_sp2
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.kernels import fine_epilogue as fe
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import make_plan

from former_fine_output import (
    ACCUMS,
    bits,
    fine_case,
    former_fine_spgemm,
    former_output,
    union_slots_of,
)

T = torch.tensor
# name: (alpha, beta).  SP2's two branches (X·X: 1, 0; 2X - X·X: -1, 2) as
# the scan makes them, 0-dim tensors; numbers, static 1 included; powers
# of two and not.
FACTORS = {
    "static_one": (1.0, 1.0),
    "sp2_square": (T(1.0), T(0.0)),
    "sp2_affine": (T(-1.0), T(2.0)),
    "numbers": (0.3, -1.7),
    "tensors": (T(0.7), T(-2.3)),
    "mixed": (-1.0, T(0.1)),
}


@pytest.mark.parametrize("planned", [False, True], ids=["unplanned", "planned"])
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("factors", list(FACTORS))
@pytest.mark.parametrize("b", [16, 32, 64])
def test_fine_output_equals_the_former_passes_bitwise(b, factors, accum, planned):
    alpha, beta = FACTORS[factors]
    a, bm, acc, pair_cap, out_cap, row_caps = fine_case(b, accum, seed=b + len(factors), device="cpu")
    kw = dict(alpha=alpha, beta=beta, accum=acc, row_caps=row_caps, backend="fine")
    if planned:
        kw["plan"] = make_plan(a, bm, pair_cap, accum_ids=None if acc is None else acc.ids,
                               out_cap=None if acc is None else out_cap)
    c, info = tx.spgemm(a, bm, pair_cap, out_cap, **kw)
    assert not any(bool(getattr(info, f)) for f in (
        "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch"))
    valid = c.ids != SENTINEL
    assert int(valid.sum()) == int(c.nnz) <= out_cap - 4 and not bool(valid[-4:].any())
    want = former_fine_spgemm(a, bm, c.ids, row_caps, alpha, beta, acc)
    assert c.data.dtype == want.dtype and torch.equal(bits(c.data), bits(want))
    # The plain version alone, on the kernel's C^T blocks of this product.
    ct = pallas_gemm_fine.fine_spgemm(
        a.ids, a.data, bm.ids, bm.data, c.ids, a.nb_rows, bm.nb_rows, bm.nb_cols, out_cap,
        *row_caps, out_layout="flat").view(out_cap, b, b)
    acc_data, pos = (None, None) if acc is None else (acc.data, union_slots_of(c.ids, acc.ids))
    got = fe.fine_epilogue_reference(ct, c.ids, alpha, acc_data, pos, beta)
    assert torch.equal(bits(got), bits(former_output(
        ct.transpose(-1, -2).contiguous(), c.ids, alpha, acc_data, pos, beta)))
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_plain_version_casts_as_the_former_passes(dtype):
    """On the CPU the plain version writes other output types with the
    former passes' casts: alpha's product rounded to the type, the
    accumulate in promote_types(type, f32).  (The kernel's own casts are
    held to them in the card tests.)"""
    gen = torch.Generator().manual_seed(3)
    ct = torch.randn((9, 16, 16), generator=gen)
    ids = torch.tensor([1, 4, 5, 8, 20, 31] + [SENTINEL] * 3, dtype=torch.int32)
    ct[6:] = 0.0
    acc = torch.randn((4, 16, 16), generator=gen).to(dtype)
    pos = torch.tensor([1, 3, 9, 6], dtype=torch.int32)  # two rows land nowhere
    for alpha, beta in ((1.0, 1.0), (T(-1.0), T(2.0)), (0.3, -1.7)):
        got = fe.fine_epilogue(ct, ids, alpha, acc, pos, beta, dtype=dtype)
        want = former_output(ct.transpose(-1, -2).contiguous(), ids, alpha, acc, pos, beta,
                             dtype=dtype)
        assert got.dtype == dtype and torch.equal(bits(got), bits(want))


MOLECULES, STEPS, SEED = 64, 32, 2**31 + 2301


@pytest.fixture(scope="module")
def x0():
    """X0 = (rho I - F) / (2 rho) of the b3_sp2.planned deployment cut to
    64 molecules, as the benchmark's session makes it."""
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, "b3_sp2.planned")
    cell.cfg["molecules"] = MOLECULES
    cell.cfg["assumed"].update(n_occ=5 * MOLECULES, n_steps=STEPS)
    m = ref_sp2.make_inputs(cell.cfg, 1, SEED, "cpu")[0]
    f = sys_sp2.matrix(m.ids, m.data, m.n, m.b)
    rho = tx.gershgorin_bound(f)
    x = tx.add(tx.eye(m.n, m.b, device="cpu"), f, alpha=0.5, beta=-0.5 / rho)
    return x, cell.cfg["assumed"]


def former_pass(ct, out_ids, alpha=1.0, acc_data=None, pos_acc=None, beta=1.0,
                dtype=torch.float32):
    """The former passes in the output pass's place: `_output`'s transpose,
    then the ×alpha `where`, the gather and the ×beta add."""
    return former_output(ct.transpose(-1, -2).contiguous(), out_ids, alpha, acc_data,
                         pos_acc, beta, dtype)


def test_planned_sp2_scan_equals_the_former_path_bitwise(x0, monkeypatch):
    x, cfg = x0
    eng = tx.PurifyEngine(STEPS, cfg["tau"], target_trace=cfg["n_occ"])
    xp, sp = eng.run(x)
    assert eng.n_replans == 1 and not bool(sp.plan_mismatch.any())
    monkeypatch.setattr(fe, "fine_epilogue", former_pass)
    former = tx.PurifyEngine(STEPS, cfg["tau"], target_trace=cfg["n_occ"])
    xf, sf = former.run(x)
    assert torch.equal(xp.ids, xf.ids) and torch.equal(xp.nnz, xf.nnz)
    assert torch.equal(bits(xp.data), bits(xf.data))
    for f in dataclasses.fields(sf):
        assert torch.equal(getattr(sp, f.name), getattr(sf, f.name)), f.name
