"""The port's acceptance checks (`scripts/acceptance.py` of the port) at
small sizes on the CPU: each passes against its float64 oracle within
acceptance.py's tolerance, and the matrices it checked equal the JAX
package's public ops on the same numpy input (backend "xla"): ids and nnz
exactly, payloads within rtol = atol = 1e-5 at "highest" and 2e-2 at
"default", on payloads scaled by max|C| (the checks' own measure)."""

import jax.numpy as jnp
import numpy as np
import pytest

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.models.purification import purify_scan
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu.utils import generators as jgen
from hierarchical_block_sparse_lib_tpu_torch.scripts import acceptance

from torch_port_helpers import np_, torch_threads

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def same_as_jax(port_m, jax_m, tol=1e-5):
    np.testing.assert_array_equal(np_(port_m.ids), np_(jax_m.ids))
    assert int(port_m.nnz) == int(jax_m.nnz)
    want = np.asarray(jax_m.data)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np_(port_m.data) / scale, want / scale, rtol=tol, atol=tol)


def jax_product(a, b=None, **kw):
    b = a if b is None else b
    pc, oc, _, _ = plan_spgemm_ex(a, b)
    return jx.spgemm(a, b, pc, oc, backend="xla", **kw)[0]


def jax_scaled_random(n, b, n_blocks, seed):
    """acceptance.py's random inputs (N(0, 0.01) blocks) in the JAX package."""
    nb = n // b
    r = np.random.default_rng(seed)
    ids = np.sort(r.choice(nb * nb, n_blocks, replace=False)).astype(np.int32)
    data = r.standard_normal((n_blocks, b, b)).astype(np.float32) * 0.1
    return jx.BlockMatrix(ids=jnp.asarray(ids), data=jnp.asarray(data),
                          nnz=jnp.asarray(n_blocks, jnp.int32), n_rows=n, n_cols=n, block_size=b)


def jax_band(n, bw, leaf, coarsen=1):
    r, c, v = jgen.banded_coo(n, bw, seed=0)
    a = jx.from_coo(r, c, v, n, block_size=leaf)
    return jx.coarsen(a, coarsen) if coarsen > 1 else a


@pytest.mark.parametrize("check", ["b1_banded", "b1_leaf16_direct"])
def test_b1_checks_match_jax(check):
    n, bw = 512, 16
    got = getattr(acceptance, check)(n, bw, device=DEV)
    same_as_jax(got, jax_product(jax_band(n, bw, 16, 8 if check == "b1_banded" else 1)))


def test_b2_chain_matches_jax():
    n, b, dens = 1024, 128, 0.1
    got = acceptance.b2_chain(n, b, dens, device=DEV)
    nblk = int(dens * (n // b) ** 2)
    a, bm = jax_scaled_random(n, b, nblk, 11), jax_scaled_random(n, b, nblk, 12)
    c = jax_product(a, bm, alpha=0.5)
    same_as_jax(got, jx.scale(jx.add(c, a, beta=0.25), 2.0))


def test_b2_leaf32_headline_matches_jax():
    n, bf, dens = 1024, 32, 0.05
    direct, flat = acceptance.b2_leaf32_headline(n, bf, dens, device=DEV)
    want = jax_product(jax_scaled_random(n, bf, int(round(dens * (n // bf) ** 2)), 2))
    same_as_jax(direct, want)
    same_as_jax(flat, want)


def test_b3_purification_matches_jax():
    n, b, nocc, bw, steps = 512, 128, 128, 20, 40
    got = acceptance.b3_purification(n, b, nocc, bw, steps, device=DEV)
    r, c, v = jgen.banded_coo(n, bw, seed=3)
    dh = np.asarray(jx.to_dense(jx.from_coo(r, c, v, n, block_size=b))).astype(np.float64)
    dh = (dh + dh.T) / 2
    h = jx.from_dense(jnp.asarray(dh.astype(np.float32)), block_size=b)
    w = np.linalg.eigvalsh(dh)
    lo, hi = w[0], w[-1]
    x = jx.add(jx.eye(n, b, cap=h.cap + n // b), h, alpha=hi / (hi - lo), beta=-1.0 / (hi - lo))
    nb = n // b
    xf, _ = purify_scan(x, steps, tau=1e-7, pair_cap=nb**3, out_cap=nb * nb, target_trace=nocc,
                        row_caps=(nb, nb), backend="xla")
    same_as_jax(got, xf)


def test_b4_near_dense_matches_jax():
    n, b, dens = 1024, 128, 0.5
    rows, slabs = acceptance.b4_near_dense(n, b, dens, device=DEV)
    want = jax_product(jax_scaled_random(n, b, int(dens * (n // b) ** 2), 42))
    same_as_jax(rows, want)
    same_as_jax(slabs, want)


def test_precision_modes_match_jax():
    n, bw = 512, 24
    got = acceptance.precision_modes(n, bw, device=DEV)
    a = jax_band(n, bw, 16, 8)
    for prec, tol in (("highest", 1e-5), ("default", 2e-2)):
        same_as_jax(got[prec], jax_product(a, precision=prec), tol)


def test_failed_check_raises(capsys):
    """A check above its tolerance prints FAIL and raises (a non-zero exit
    of the script)."""
    with pytest.raises(AssertionError, match="max_rel"):
        acceptance.check("too far", 2e-5)
    assert "too far: max_rel=2.00e-05 [FAIL]" in capsys.readouterr().out


def test_main_runs_every_check_in_order(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(acceptance, "CHECKS", tuple(
        (lambda name: (lambda device: ran.append((name, device))))(f.__name__)
        for f in acceptance.CHECKS))
    assert acceptance.main(device=DEV) == 0
    assert [name for name, _ in ran] == ["b1_banded", "b1_leaf16_direct", "b2_chain",
                                         "b2_leaf32_headline", "b3_purification",
                                         "b4_near_dense", "precision_modes"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == "ALL ACCEPTANCE CHECKS PASSED"
    monkeypatch.setattr(acceptance.torch.cuda, "is_available", lambda: False)
    assert acceptance.main() == 2
