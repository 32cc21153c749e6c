"""The truncation's two passes (kernels/csrc/truncate.cu) on the card.

- The norm pass at leaves 16, 32, 64 and 128 in f32, bf16 and f64: norms
  within 1e-6 of a float64 sum, keep equal to the former chain's wherever
  the norm lies more than a few ulps from tau^2, tau as a number and as a
  0-dim tensor on the card.
- The compaction: given one keep mask, ids, blocks, nnz and kept bit for bit
  those of the plain compaction, with and without `cap`, `kept > cap`,
  nothing kept, everything kept, all padding, in leaf and subtree mode.
- At b % 128 == 0 in f32 and bf16 (keep from the norms kernel) and in
  subtree mode, the whole truncation bit for bit the former one
  (`former_truncate.py`).
- The b3_sp2.planned step's capacities; two counted passes a truncation; no
  host sync with tau on the card; a planned SP2 scan at 64 molecules, with
  the blocks whose keep differs from the former chain's counted and each
  within rounding of tau^2.

Needs a CUDA card (marker `card`; each test skips without one).  On a
machine with one, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_truncate_card.py

(`--noconftest`: the suite's conftest sets up the JAX package, which this
file does not use.)
"""

import dataclasses
import os

import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms
from hierarchical_block_sparse_lib_tpu_torch.kernels import truncate as tk
from hierarchical_block_sparse_lib_tpu_torch.ops import truncate as trunc_ops
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import squared_threshold

from former_truncate import (
    assert_same_truncation,
    bits,
    former_truncate,
    sp2_step_matrix,
    spread_matrix,
    tau_keeping,
)

pytestmark = pytest.mark.card

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
ULPS = 8  # "within rounding of tau^2": this many ulps of tau^2 in the norms' type


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the truncate kernels run only there")
    return torch.device("cuda")


def case(b, dtype, device, seed=0, cap=600, n_valid=500, nb=40):
    a = spread_matrix(cap, n_valid, b, nb, seed + b, device, DTYPES[dtype])
    return a, tau_keeping(a, 0.3)


def near_tau(n2_64, tau, dtype):
    """Slots whose float64 norm^2 lies within ULPS ulps of tau^2 in the
    norms' accumulation type."""
    tdt = torch.promote_types(dtype, torch.float32)
    t2 = float(squared_threshold(tau, tdt))
    return (n2_64 - t2).abs() <= ULPS * torch.finfo(tdt).eps * t2


def tau_arg(tau, kind, device):
    return torch.tensor(tau, device=device) if kind == "tensor" else tau


@pytest.mark.parametrize("kind", ["number", "tensor"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_norm_pass_against_float64_and_the_former_keep(card, b, dtype, kind):
    """The norm pass's norms within 1e-6 of a float64 sum (0 at padding);
    its keep equal to the former chain's and to the float64 decision
    except within rounding of tau^2; repeated calls bit for bit equal."""
    a, tau = case(b, dtype, card)
    tdt = torch.promote_types(DTYPES[dtype], torch.float32)
    t = tau_arg(tau, kind, card)
    launches = tk.truncate_kernel.launches
    n2, keep = tk.block_norms_keep(a.ids, a.data, squared_threshold(t, tdt))
    assert tk.truncate_kernel.launches == launches + 1 and n2.dtype == tdt
    valid = a.ids != SENTINEL
    n2_64 = a.data.double().square().sum(dim=(1, 2))
    assert torch.all(n2[~valid] == 0) and not keep[~valid].any()
    rel = ((n2.double() - n2_64).abs() / n2_64.clamp(min=1e-300))[valid]
    assert float(rel.max()) <= 1e-6, float(rel.max())
    near = near_tau(n2_64, tau, DTYPES[dtype])
    exact = valid & (n2_64 > float(squared_threshold(tau, torch.float64)))
    former = trunc_ops.keep_reference(a, t)
    assert torch.equal(keep[~near], exact[~near])
    assert torch.equal(keep[~near], former[~near])
    n2b, keepb = tk.block_norms_keep(a.ids, a.data, squared_threshold(t, tdt))
    assert torch.equal(n2b, n2) and torch.equal(keepb, keep)


CAPS = {"none": None, "wider": 900, "over": 100, "tight": 1}


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_truncation_against_the_plain_compaction_bitwise(card, b, dtype, cap):
    """`truncate` on the card: given its own keep, ids, blocks, nnz and kept
    bit for bit those of the plain compaction; at b % 128 == 0 in f32 and
    bf16 the whole truncation bit for bit the former one; two counted
    passes."""
    a, tau = case(b, dtype, card, seed=len(cap))
    cap = CAPS[cap]
    launches = tk.truncate_kernel.launches
    got = tx.truncate(a, tau, cap=cap)
    torch.cuda.synchronize()
    assert tk.truncate_kernel.launches == launches + 2
    tdt = torch.promote_types(DTYPES[dtype], torch.float32)
    if pallas_norms.supported(b, DTYPES[dtype]):
        keep = trunc_ops.keep_reference(a, tau)
    else:
        keep = tk.block_norms_keep(a.ids, a.data, squared_threshold(tau, tdt))[1]
    m, kept = trunc_ops.compact_reference(a, keep, cap)
    assert_same_truncation(got, m if cap is None else (m, kept))
    if cap is not None and cap < int(keep.sum()):
        assert int(got[1]) > cap == int(got[0].nnz)
    if pallas_norms.supported(b, DTYPES[dtype]):
        assert_same_truncation(got, former_truncate(a, tau, cap=cap))


@pytest.mark.parametrize("cap", [None, 50])
@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("b", [32, 128])
def test_subtree_truncation_equals_the_former_bitwise(card, b, level, cap):
    """Subtree mode keeps its node norms' mask; the compaction gives the
    former truncation's bits."""
    a, _ = case(b, "f32", card, seed=level, nb=16, cap=256, n_valid=200)
    _, node_n2 = tx.subtree_frob_squared(a, level)
    tau = float(node_n2[node_n2 > 0].median().sqrt())
    launches = tk.truncate_kernel.launches
    got = tx.truncate(a, tau, subtree_level=level, cap=cap)
    assert tk.truncate_kernel.launches == launches + 2
    assert_same_truncation(got, former_truncate(a, tau, subtree_level=level, cap=cap))


EDGES = ("none_kept", "all_kept", "all_padding", "one_slot", "no_valid_tail")


@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("b", [16, 32])
def test_edges(card, b, edge, cap):
    """Nothing kept (tau above every norm), everything kept (tau 0, no zero
    block), all padding, a single slot, and a full matrix with no padding:
    the plain compaction's bits and counts."""
    n = {"all_padding": 0, "one_slot": 1}.get(edge, 40)
    slots = {"one_slot": 1, "no_valid_tail": 40}.get(edge, 64)
    a = spread_matrix(slots, n, b, 12, 7, card)
    tau = {"none_kept": 1e9}.get(edge, 0.0)
    got = tx.truncate(a, tau, cap=cap)
    tdt = torch.float32
    keep = tk.block_norms_keep(a.ids, a.data, squared_threshold(tau, tdt))[1]
    assert int(keep.sum()) == {"none_kept": 0, "all_padding": 0}.get(edge, n)
    m, kept = trunc_ops.compact_reference(a, keep, cap)
    assert_same_truncation(got, m if cap is None else (m, kept))
    want = former_truncate(a, tau, cap=cap)  # no norm near tau^2 in these cases
    assert_same_truncation(got, want)


def test_fine_payload_truncation(card):
    """`fine_truncate` on the fine layout's [cap, b*b/128, 128] payloads:
    the plain compaction's bits given the norm pass's keep on them."""
    a, tau = case(32, "f32", card, seed=5)
    af = tx.fine_pack(a)
    shim = dataclasses.replace(a, ids=af.ids, data=af.data, nnz=af.nnz)
    keep = tk.block_norms_keep(af.ids, af.data, squared_threshold(tau, torch.float32))[1]
    want, _ = trunc_ops.compact_reference(shim, keep, 200)
    got = tx.fine_truncate(af, tau, cap=200)
    assert got.data.shape == want.data.shape
    assert torch.equal(got.ids, want.ids) and torch.equal(got.nnz, want.nnz)
    assert torch.equal(bits(got.data), bits(want.data))


def test_tau_as_a_tensor_on_the_card_gives_the_numbers_bits(card):
    a, tau = case(32, "f32", card, seed=3)
    got = tx.truncate(a, torch.tensor(tau, device=card), cap=200)
    assert_same_truncation(got, tx.truncate(a, tau, cap=200))


def test_refusals(card):
    a, tau = case(32, "f32", card)
    with pytest.raises(ValueError, match="f32, bf16 or f64"):
        tx.truncate(a.with_data(a.data.half()), tau)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.truncate_kernel(a.ids, torch.zeros((a.cap, 1, 2), device=card), 4, tau2=1.0)
    with pytest.raises(ValueError, match="keep"):
        tk.truncate_kernel(a.ids, a.data, 4, keep=torch.zeros((3,), dtype=torch.bool,
                                                              device=card))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_at_the_sp2_steps_capacities(card, dtype):
    """262 144 slots of 32 x 32, 172 000 valid, cap 65 536: given the same
    keep, the plain compaction's bits; keep against the former chain's
    except within rounding of tau^2."""
    a, tau = sp2_step_matrix(card, seed=1, dtype=DTYPES[dtype])
    got = tx.truncate(a, tau, cap=65_536)
    keep = tk.block_norms_keep(a.ids, a.data, squared_threshold(tau, torch.float32))[1]
    m, kept = trunc_ops.compact_reference(a, keep, 65_536)
    assert_same_truncation(got, (m, kept))
    assert 15_000 < int(kept) < 35_000
    near = near_tau(a.data.double().square().sum(dim=(1, 2)), tau, DTYPES[dtype])
    former = trunc_ops.keep_reference(a, tau)
    assert torch.equal(keep[~near], former[~near])
    m_over, kept_over = tx.truncate(a, tau, cap=10_000)
    assert int(kept_over) == int(kept) and int(m_over.nnz) == 10_000
    assert torch.equal(m_over.ids, m.ids[:10_000])


def test_no_host_sync_with_tau_on_the_card(card):
    a, tau = case(32, "f32", card)
    a128, tau128 = case(128, "f32", card, cap=40, n_valid=30, nb=8)
    t, t128 = torch.tensor(tau, device=card), torch.tensor(tau128, device=card)
    tx.truncate(a, t, cap=100)
    torch.cuda.synchronize()
    launches = tk.truncate_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tx.truncate(a, t, cap=100)
        tx.truncate(a, t)
        tx.truncate(a128, t128, cap=20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tk.truncate_kernel.launches == launches + 6


def test_planned_sp2_scan_against_the_former_chain(card, monkeypatch):
    """The b3_sp2.planned deployment cut to 64 molecules: the engine's
    planned scan, 32 steps, two passes a step.  At every step the kernels'
    keep is held against the former chain's on the same product: each block
    where they differ lies within rounding of tau^2 (the count is printed);
    where none differ, the scan equals the former path's bit for bit."""
    from benchmark import harness
    from benchmark.reference import sp2 as ref_sp2
    from benchmark.systems import sp2 as sys_sp2
    from hierarchical_block_sparse_lib_tpu_torch.models import purification

    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, "b3_sp2.planned")
    cell.cfg["molecules"] = 64
    cell.cfg["assumed"].update(n_occ=320, n_steps=32)
    m = ref_sp2.make_inputs(cell.cfg, 1, 2**31 + 2501, card)[0]
    f = sys_sp2.matrix(m.ids, m.data, m.n, m.b)
    x = tx.add(tx.eye(m.n, m.b, device=card), f, alpha=0.5, beta=-0.5 / tx.gershgorin_bound(f))
    cfg = cell.cfg["assumed"]
    tau = cfg["tau"]
    eng = tx.PurifyEngine(32, tau, target_trace=cfg["n_occ"])
    eng.run(x)
    torch.cuda.synchronize()

    differ = []
    real = purification.truncate

    def recorded(y, t, subtree_level=None, cap=None):
        keep = tk.block_norms_keep(y.ids, y.data, squared_threshold(t, torch.float32))[1]
        off = keep != trunc_ops.keep_reference(y, t)
        near = near_tau(y.data.double().square().sum(dim=(1, 2)), t, y.dtype)
        assert not bool((off & ~near).any())
        differ.append(int(off.sum()))
        return real(y, t, subtree_level, cap)

    monkeypatch.setattr(purification, "truncate", recorded)
    launches = tk.truncate_kernel.launches
    xp, sp = eng.run(x)
    torch.cuda.synchronize()
    assert tk.truncate_kernel.launches == launches + 32 * 3  # + the recorder's norm pass
    assert eng.n_replans == 1 and not bool(sp.plan_mismatch.any())
    print(f"planned SP2 scan at 64 molecules: {sum(differ)} keep decisions of the kernels "
          f"differ from the former chain's over 32 steps, each within rounding of tau^2")
    if sum(differ) == 0:
        monkeypatch.setattr(purification, "truncate", former_truncate)
        former = tx.PurifyEngine(32, tau, target_trace=cfg["n_occ"])
        xf, sf = former.run(x)
        assert_same_truncation(xp, xf)
        assert torch.equal(sp.nnz_blocks, sf.nnz_blocks)
        assert torch.equal(sp.trace, sf.trace)
