"""The plain reference against dense float64 NumPy and against the
port's CPU path, at a tiny size; the control's rounding."""

import numpy as np
import pytest
import torch

from bench_small import SEED, small_cell
from benchmark.reference import chain, common
from benchmark.systems import chain as chain_sys


def dense_np(ids, data, nb):
    b = data.shape[-1]
    out = np.zeros((nb * b, nb * b))
    for i, blk in zip(ids, data.double().numpy()):
        r, c = divmod(int(i), nb)
        out[r * b:(r + 1) * b, c * b:(c + 1) * b] = blk
    return out


def test_chain_reference_against_numpy():
    cfg = small_cell("b2_chain.planned").cfg
    m = chain.make_inputs(cfg, 1, SEED, "cpu")[0]
    nb = m.n // m.b
    ref = chain.reference(cfg, m)
    a, b = dense_np(m.a_ids, m.a_data, nb), dense_np(m.b_ids, m.b_data, nb)
    d = cfg["gamma"] * (cfg["alpha"] * a @ b + cfg["beta"] * a)
    got = dense_np(ref["ids"], ref["data"], nb)
    assert np.abs(got - d).max() <= 1e-12 * np.abs(d).max()
    # Every nonzero block of D is in the reference's support.
    blocks = np.abs(d).reshape(nb, m.b, nb, m.b).sum(axis=(1, 3)) > 0
    assert set(np.flatnonzero(blocks)) <= set(ref["ids"].tolist())


@pytest.mark.parametrize("workload", ("b2_chain.planned", "b2_chain.oneoff"))
def test_chain_reference_against_the_port_on_cpu(workload):
    cell = small_cell(workload)
    m = chain.make_inputs(cell.cfg, 1, SEED, "cpu")[0]
    s = chain_sys.Session(cell.cfg, cell.traffic, [m])
    got = s.export(s.call(0))
    nums = chain.compare(got, chain.reference(cell.cfg, m))
    assert nums["ids_diff"] == nums["pairs_diff"] == nums["out_diff"] == 0
    assert nums["d_err"] < 1e-6


@pytest.mark.parametrize("x", [1.0, -3.0e-5, 123.456, 1.0009765625, 1.00048828125])
def test_round_tf32(x):
    got = float(common.round_tf32(torch.tensor([x], dtype=torch.float32)))
    m, e = np.frexp(np.float32(x))
    want = np.ldexp(np.round(m * 2**11) / 2**11, e)  # 11 significant bits, ties to even
    assert got == pytest.approx(float(want), rel=0, abs=0)
