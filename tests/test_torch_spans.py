"""The port's profiler spans (`utils/profiling.py::span`): the ``hbsm.*``
ranges each op records under ``torch.profiler`` (the chain's, and SP2's
``hbsm.purify``, ``hbsm.replan``, ``hbsm.engine_check`` and
``hbsm.truncate``), their nesting, the shared no-op without a profiler,
answers equal either way, and a span that closes when its op raises.  On the CPU the fine kernel's plain
version builds its tables without `fine_tables`, so the front door's
product holds no ``hbsm.symbolic`` here (on the card it holds one)."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_groups import plan_groups
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    plan_spamm,
    plan_spgemm,
    plan_spgemm_ex,
    plan_syrk,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span

N, B, DENSITY = 512, 32, 0.3  # 16 block rows: the front door plans no row groups

PLANNED = [("hbsm.fine_matmul", ["hbsm.product"]), ("hbsm.add", ["hbsm.union"]), "hbsm.scale"]
FRONT_DOOR = [
    ("hbsm.matmul", ["hbsm.host_plan", ("hbsm.spgemm", ["hbsm.symbolic", "hbsm.product"])]),
    ("hbsm.add", ["hbsm.union"]),
    "hbsm.scale",
]


@pytest.fixture(scope="module")
def operands():
    a = random_block_matrix(N, B, DENSITY, seed=1, device="cpu")
    b = random_block_matrix(N, B, DENSITY, seed=2, device="cpu")
    pc, oc, mbr, mcr = plan_spgemm_ex(a, b)
    assert pc >= 16 * a.nb_rows
    af, bf = hbsm.fine_pack(a), hbsm.fine_pack(b)
    fplan = hbsm.make_fine_plan(a, b, pc, oc, (mbr, mcr))
    return a, b, af, bf, (pc, oc, (mbr, mcr)), fplan


def planned_chain(ops):
    _, _, af, bf, (pc, oc, caps), fplan = ops
    c, _ = hbsm.fine_matmul(af, bf, pc, oc, caps, alpha=0.5, plan=fplan)
    return hbsm.fine_scale(hbsm.fine_add(c, af, beta=0.25), 2.0)


def front_door_chain(ops):
    a, b = ops[:2]
    c, _ = hbsm.matmul(a, b, alpha=0.5)
    return hbsm.scale(hbsm.add(c, a, beta=0.25), 2.0)


def span_tree(prof):
    """The ``hbsm.`` ranges of a profile as a forest: a leaf is its name,
    a node (name, [children]), in order of start."""
    ranges = sorted(
        ((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
         for e in prof.profiler.kineto_results.events() if e.name().startswith("hbsm.")),
        key=lambda r: (r[0], -r[1]),
    )
    roots, stack = [], []
    for s, t, name in ranges:
        while stack and stack[-1][0] <= s:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((t, node))

    def form(nodes):
        return [(n, form(c)) if c else n for n, c in nodes]

    return form(roots)


def traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, span_tree(prof)


@pytest.mark.parametrize("chain, want", [(planned_chain, PLANNED), (front_door_chain, FRONT_DOOR)],
                         ids=["planned", "front_door"])
def test_chain_records_its_spans(operands, chain, want):
    _, tree = traced(chain, operands)
    assert tree == want


@pytest.mark.parametrize("chain", [planned_chain, front_door_chain], ids=["planned", "front_door"])
def test_answers_equal_with_profiler_on_and_off(operands, chain):
    off = chain(operands)
    on, _ = traced(chain, operands)
    assert torch.equal(off.ids, on.ids) and torch.equal(off.nnz, on.nnz)
    assert torch.equal(off.data, on.data)


def test_no_profiler_no_span(operands, monkeypatch):
    assert span("hbsm.a") is span("hbsm.b")
    with span("hbsm.a") as inside:
        assert inside is None

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    planned_chain(operands)
    front_door_chain(operands)


def test_span_closes_when_the_op_raises(operands):
    _, _, af, bf, (pc, oc, caps), fplan = operands

    def raising_then_scale():
        with pytest.raises(ValueError, match="out_cap"):
            hbsm.fine_matmul(af, bf, pc, oc + 1, caps, plan=fplan)
        with pytest.raises(ValueError, match="shape mismatch"):
            hbsm.add(operands[0], random_block_matrix(2 * N, B, DENSITY, seed=3, device="cpu"))
        return hbsm.fine_scale(af, 2.0)

    _, tree = traced(raising_then_scale)
    assert tree == ["hbsm.fine_matmul", "hbsm.add", "hbsm.scale"]


@pytest.mark.parametrize("planner", ["plan_spgemm_ex", "plan_spgemm", "plan_syrk", "plan_spamm",
                                     "plan_groups"])
def test_host_planners_record_host_plan(planner):
    b = 128 if planner == "plan_groups" else B
    a = random_block_matrix(8 * b, b, 0.4, seed=4, device="cpu")
    call = {
        "plan_spgemm_ex": lambda: plan_spgemm_ex(a, a),
        "plan_spgemm": lambda: plan_spgemm(a, a),
        "plan_syrk": lambda: plan_syrk(a),
        "plan_spamm": lambda: plan_spamm(a, a, 1.0),
        "plan_groups": lambda: plan_groups(a, a),
    }[planner]
    _, tree = traced(call)
    assert tree == ["hbsm.host_plan"]


def test_structure_spans(operands):
    """The symbolic phase and the union outside any entry op: the fine
    plan (the pair enumeration inside the structure pass, then the
    kernel's tables) and the planned add."""
    a, b, _, _, (pc, oc, caps), _ = operands
    _, tree = traced(hbsm.make_fine_plan, a, b, pc, oc, caps)
    assert tree == [("hbsm.symbolic", ["hbsm.symbolic"]), "hbsm.symbolic"]
    plan = hbsm.make_add_plan(a.ids, b.ids, a.cap + b.cap)
    _, tree = traced(hbsm.add_planned, a, b, plan)
    assert tree == ["hbsm.union"]


ENGINE_STEPS, ENGINE_TAU, ENGINE_TARGET = 2, 1e-3, 128.0


@pytest.fixture(scope="module")
def sp2_input():
    """A shifted random matrix at leaf 32 (8 block rows) for the engine."""
    a = random_block_matrix(N // 2, B, DENSITY, seed=1, device="cpu")
    return hbsm.add(hbsm.scale(a, 0.01), hbsm.eye(N // 2, B, device="cpu"), beta=0.5)


def names(nodes):
    return [n if isinstance(n, str) else n[0] for n in nodes]


def test_purify_engine_records_its_spans(sp2_input):
    """`PurifyEngine.run` is one ``hbsm.purify``: the replan (first call)
    or the structure check, then the scan's own ``hbsm.purify`` (each
    step a planned product and a truncation), then the flag check."""
    eng = hbsm.PurifyEngine(ENGINE_STEPS, ENGINE_TAU, target_trace=ENGINE_TARGET)
    _, first = traced(eng.run, sp2_input)
    _, again = traced(eng.run, sp2_input)
    assert eng.n_replans == 1
    scan = ("hbsm.purify", [("hbsm.spgemm", ["hbsm.product"]), "hbsm.truncate"] * ENGINE_STEPS)
    assert again == [("hbsm.purify", ["hbsm.engine_check", scan, "hbsm.engine_check"])]
    [(name, kids)] = first
    assert name == "hbsm.purify"
    assert names(kids) == ["hbsm.replan", "hbsm.purify", "hbsm.engine_check"]
    assert kids[1] == scan
    # The replan profiles and plans the trajectory: host plans, symbolic
    # phases, unions, products and truncations, all under its span.
    assert set(names(kids[0][1])) == {"hbsm.host_plan", "hbsm.spgemm", "hbsm.truncate",
                                      "hbsm.symbolic", "hbsm.union"}


def test_truncate_records_its_span(sp2_input):
    _, tree = traced(hbsm.truncate, sp2_input, ENGINE_TAU)
    assert tree == ["hbsm.truncate"]
    _, tree = traced(hbsm.truncate, sp2_input, ENGINE_TAU, 1)
    assert tree == ["hbsm.truncate"]


def test_purify_spans_cost_nothing_without_a_profiler(sp2_input, monkeypatch):
    on_eng = hbsm.PurifyEngine(ENGINE_STEPS, ENGINE_TAU, target_trace=ENGINE_TARGET)
    on, _ = traced(on_eng.run, sp2_input)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng = hbsm.PurifyEngine(ENGINE_STEPS, ENGINE_TAU, target_trace=ENGINE_TARGET)
    eng.run(sp2_input)
    off = eng.run(sp2_input)
    hbsm.truncate(sp2_input, ENGINE_TAU)
    assert eng.n_replans == 1
    assert torch.equal(off[0].ids, on[0].ids) and torch.equal(off[0].data, on[0].data)
