"""spgemm's fine-branch output pass (kernels/csrc/fine_epilogue.cu) on the
card: bit for bit equal to its plain version and to the passes it replaced
(`former_fine_output.py`) at leaves 16, 32 and 64, with alpha and beta as
numbers and as 0-dim tensors on the card, every accumulator case, planned
and unplanned, with D in f32, bf16 and f64 and the accumulator in D's type
or another, and at the b3_sp2.planned step's capacities (262 144 slots);
one counted call a fine-branch spgemm and none on `fine_matmul`'s flat
path; no host sync with factors on the card; a planned SP2 scan at 64
molecules equal to the former path's.

Needs a CUDA card (marker `card`; each test skips without one).  On a
machine with one, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fine_epilogue_card.py

(`--noconftest`: the suite's conftest sets up the JAX package, which this
file does not use.)
"""

import dataclasses
import os

import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu_torch.kernels import fine_epilogue as fe
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import make_plan

from former_fine_output import (
    ACCUMS,
    bits,
    fine_case,
    former_fine_spgemm,
    former_output,
    sp2_step_operands,
    union_slots_of,
)

pytestmark = pytest.mark.card

FACTORS = ("static_one", "sp2_square", "sp2_affine", "numbers", "tensors", "mixed")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fine epilogue kernel runs only there")
    return torch.device("cuda")


def factors(name, device):
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731
    return {
        "static_one": (1.0, 1.0),
        "sp2_square": (t(1.0), t(0.0)),
        "sp2_affine": (t(-1.0), t(2.0)),
        "numbers": (0.3, -1.7),
        "tensors": (t(0.7), t(-2.3)),
        "mixed": (-1.0, t(0.1)),
    }[name]


@pytest.mark.parametrize("planned", [False, True], ids=["unplanned", "planned"])
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("name", FACTORS)
@pytest.mark.parametrize("b", [16, 32, 64])
def test_spgemm_fine_output_equals_the_former_passes_bitwise(card, b, name, accum, planned):
    alpha, beta = factors(name, card)
    a, bm, acc, pair_cap, out_cap, row_caps = fine_case(b, accum, seed=b + len(name), device=card)
    kw = dict(alpha=alpha, beta=beta, accum=acc, row_caps=row_caps, backend="fine")
    if planned:
        kw["plan"] = make_plan(a, bm, pair_cap, accum_ids=None if acc is None else acc.ids,
                               out_cap=None if acc is None else out_cap)
    launches = fe.fine_epilogue.launches
    c, info = tx.spgemm(a, bm, pair_cap, out_cap, **kw)
    torch.cuda.synchronize()
    assert fe.fine_epilogue.launches == launches + 1
    assert not any(bool(getattr(info, f)) for f in (
        "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch"))
    want = former_fine_spgemm(a, bm, c.ids, row_caps, alpha, beta, acc)
    assert torch.equal(bits(c.data), bits(want))
    ct = pallas_gemm_fine.fine_spgemm(
        a.ids, a.data, bm.ids, bm.data, c.ids, a.nb_rows, bm.nb_rows, bm.nb_cols, out_cap,
        *row_caps, out_layout="flat").view(out_cap, b, b)
    acc_data, pos = (None, None) if acc is None else (acc.data, union_slots_of(c.ids, acc.ids))
    got = fe.fine_epilogue(ct, c.ids, alpha, acc_data, pos, beta)
    assert torch.equal(bits(got), bits(fe.fine_epilogue_reference(
        ct, c.ids, alpha, acc_data, pos, beta)))
    assert torch.equal(bits(got), bits(want))


# (D's type, the accumulator's type or None): the accumulator in D's type,
# in promote_types(D's type, f32), and in another type the wrapper casts.
TYPES = {
    "f32": (torch.float32, torch.float32),
    "f32_acc_f64": (torch.float32, torch.float64),
    "f32_none": (torch.float32, None),
    "bf16": (torch.bfloat16, torch.bfloat16),
    "bf16_acc_f32": (torch.bfloat16, torch.float32),
    "bf16_acc_f64": (torch.bfloat16, torch.float64),
    "bf16_none": (torch.bfloat16, None),
    "f64": (torch.float64, torch.float64),
    "f64_acc_f32": (torch.float64, torch.float32),
    "f64_none": (torch.float64, None),
}


@pytest.mark.parametrize("name", FACTORS)
@pytest.mark.parametrize("types", list(TYPES))
@pytest.mark.parametrize("b", [16, 32, 64])
def test_kernel_writes_every_output_type_with_the_former_casts(card, b, types, name):
    """The kernel, not a plain fallback, for D in f32, bf16 and f64: one
    counted launch, bits equal to the former passes' casts (alpha's
    product rounded to D's type, the accumulate in promote_types(type,
    f32)) and to the plain version."""
    dtype, acc_type = TYPES[types]
    alpha, beta = factors(name, card)
    gen = torch.Generator(device=card).manual_seed(b + len(types))
    ids = torch.tensor([1, 4, 5, 8, 20, 31, 33, 40] + [2**31 - 1] * 3, dtype=torch.int32,
                       device=card)
    ct = torch.randn((11, b, b), generator=gen, device=card)
    ct[8:] = 0.0
    ct.view(11, -1)[:8, 0] = -0.0
    acc = pos = None
    if acc_type is not None:
        acc = torch.randn((5, b, b), generator=gen, device=card).to(acc_type)
        acc.view(5, -1)[:, 1] = -0.0
        pos = torch.tensor([1, 3, 11, 6, 7], dtype=torch.int32, device=card)  # one lands nowhere
    launches = fe.fine_epilogue.launches
    got = fe.fine_epilogue(ct, ids, alpha, acc, pos, beta, dtype=dtype)
    assert fe.fine_epilogue.launches == launches + 1 and got.dtype == dtype
    want = former_output(ct.transpose(-1, -2).contiguous(), ids, alpha, acc, pos, beta,
                         dtype=dtype)
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(got), bits(fe.fine_epilogue_reference(
        ct, ids, alpha, acc, pos, beta, dtype=dtype)))


@pytest.mark.parametrize("accum", ["none", "overlap"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64], ids=["bf16", "f64"])
def test_spgemm_fine_on_other_types_runs_the_kernel(card, dtype, accum):
    """spgemm(backend="fine") on bf16 and f64 data: the fine kernel's f32
    product through the output pass, one launch, the former passes' bits."""
    alpha, beta = factors("sp2_affine", card)
    a, bm, acc, pair_cap, out_cap, row_caps = fine_case(32, accum, seed=11, device=card)
    a, bm = (dataclasses.replace(m, data=m.data.to(dtype)) for m in (a, bm))
    if acc is not None:
        acc = dataclasses.replace(acc, data=acc.data.to(dtype))
    launches = fe.fine_epilogue.launches
    c, _ = tx.spgemm(a, bm, pair_cap, out_cap, alpha=alpha, beta=beta, accum=acc,
                     row_caps=row_caps, backend="fine")
    assert fe.fine_epilogue.launches == launches + 1 and c.data.dtype == dtype
    want = former_fine_spgemm(a, bm, c.ids, row_caps, alpha, beta, acc)
    assert torch.equal(bits(c.data), bits(want))


def test_kernel_refuses_what_it_does_not_take(card):
    ct = torch.zeros((4, 32, 32), device=card)
    ids = torch.zeros((4,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fe.fine_epilogue(ct, ids, dtype=torch.float16)
    with pytest.raises(ValueError):
        fe.fine_epilogue(ct.double(), ids, dtype=torch.float64)


@pytest.mark.parametrize("with_acc", [False, True], ids=["no_accum", "accum"])
@pytest.mark.parametrize("name", ["static_one", "sp2_affine", "numbers"])
def test_kernel_at_the_sp2_steps_capacities(card, name, with_acc):
    alpha, beta = factors(name, card)
    ct, ids, acc, pos = sp2_step_operands(card)
    if not with_acc:
        acc = pos = None
    got = fe.fine_epilogue(ct, ids, alpha, acc, pos, beta)
    want = former_output(ct.transpose(-1, -2).contiguous(), ids, alpha, acc, pos, beta)
    assert torch.equal(bits(got), bits(want))
    del want
    assert torch.equal(bits(got), bits(fe.fine_epilogue_reference(ct, ids, alpha, acc, pos, beta)))


def test_no_host_sync_and_one_pass_a_call(card):
    """A planned fine-branch spgemm with an accumulator and factors on the
    card makes no host sync, and counts one output pass; `fine_matmul`'s
    flat path counts none."""
    a, bm, acc, pair_cap, out_cap, row_caps = fine_case(32, "overlap", seed=5, device=card)
    plan = make_plan(a, bm, pair_cap, accum_ids=acc.ids, out_cap=out_cap)
    s = torch.tensor(0.3, device=card)
    kw = dict(alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s, accum=acc, row_caps=row_caps,
              backend="fine", plan=plan)
    tx.spgemm(a, bm, pair_cap, out_cap, **kw)
    torch.cuda.synchronize()
    launches = fe.fine_epilogue.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tx.spgemm(a, bm, pair_cap, out_cap, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fe.fine_epilogue.launches == launches + 1
    af, bf = tx.fine_pack(a), tx.fine_pack(bm)
    tx.fine_matmul(af, bf, pair_cap, out_cap, row_caps, alpha=0.5)
    torch.cuda.synchronize()
    assert fe.fine_epilogue.launches == launches + 1


def test_planned_sp2_scan_equals_the_former_path_bitwise(card, monkeypatch):
    """The b3_sp2.planned deployment cut to 64 molecules: the engine's
    planned scan, 32 steps, through the kernel and through the former
    passes, bit for bit; one output pass a step."""
    from benchmark import harness
    from benchmark.reference import sp2 as ref_sp2
    from benchmark.systems import sp2 as sys_sp2

    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, "b3_sp2.planned")
    cell.cfg["molecules"] = 64
    cell.cfg["assumed"].update(n_occ=320, n_steps=32)
    m = ref_sp2.make_inputs(cell.cfg, 1, 2**31 + 2301, card)[0]
    f = sys_sp2.matrix(m.ids, m.data, m.n, m.b)
    x = tx.add(tx.eye(m.n, m.b, device=card), f, alpha=0.5, beta=-0.5 / tx.gershgorin_bound(f))
    cfg = cell.cfg["assumed"]
    eng = tx.PurifyEngine(32, cfg["tau"], target_trace=cfg["n_occ"])
    eng.run(x)
    torch.cuda.synchronize()
    launches = fe.fine_epilogue.launches
    xp, sp = eng.run(x)
    torch.cuda.synchronize()
    assert fe.fine_epilogue.launches == launches + 32
    assert eng.n_replans == 1 and not bool(sp.plan_mismatch.any())

    def former_pass(ct, out_ids, alpha=1.0, acc_data=None, pos_acc=None, beta=1.0,
                    dtype=torch.float32):
        return former_output(ct.transpose(-1, -2).contiguous(), out_ids, alpha, acc_data,
                             pos_acc, beta, dtype)

    monkeypatch.setattr(fe, "fine_epilogue", former_pass)
    former = tx.PurifyEngine(32, cfg["tau"], target_trace=cfg["n_occ"])
    xf, sf = former.run(x)
    assert torch.equal(xp.ids, xf.ids) and torch.equal(xp.nnz, xf.nnz)
    assert torch.equal(bits(xp.data), bits(xf.data))
    for fld in dataclasses.fields(sf):
        assert torch.equal(getattr(sp, fld.name), getattr(sf, fld.name)), fld.name
