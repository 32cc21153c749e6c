"""PyTorch port vs the JAX package: the structural ops under the
purification path (ops/basic.py `transpose`, `union_merge`;
ops/repack.py `repack`, `coarsen`, `plan_coarsen`; core/assembly.py
`eye`; ops/spgemm.py `make_plan`, `resolve_backend`) and the device
default of the port's constructors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops.basic import union_merge as jax_union_merge
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.basic import union_merge
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import resolve_backend

from torch_port_helpers import SENTINEL, assert_same_matrix, matrix_pair, np_


def test_transpose_matches_jax():
    ja, ta = matrix_pair(5, 7, 8, 0.4, 21, empty_rows=(2,), pad=3)
    assert_same_matrix(tx.transpose(ta), jx.transpose(ja), rtol=0, atol=0)
    assert tx.transpose(ta).data.is_contiguous()


@pytest.mark.parametrize("out_cap", [40, 9])  # room to spare, overflowing
def test_union_merge_matches_jax(out_cap):
    rng = np.random.default_rng(3)
    c_id = np.sort(rng.choice(60, 25)).astype(np.int32)  # repeats, as pair lists
    c_id[-4:] = SENTINEL
    acc = np.sort(rng.choice(60, 12, replace=False)).astype(np.int32)
    acc[-2:] = SENTINEL
    got = union_merge(torch.from_numpy(c_id), torch.from_numpy(acc), out_cap)
    want = jax_union_merge(jnp.asarray(c_id), jnp.asarray(acc), out_cap)
    for name, g, w in zip(("out_ids", "seg", "pos_acc", "n_unique"), got, want):
        assert np_(g).dtype == np.int32, name
        np.testing.assert_array_equal(np_(g), np_(w), err_msg=name)


@pytest.mark.parametrize("cap", [4, 12, 20])  # shrink below nnz, same, grow
def test_repack_matches_jax(cap):
    ja, ta = matrix_pair(4, 4, 8, 0.6, 22, pad=2)
    assert ta.cap == 12
    assert_same_matrix(tx.repack(ta, cap), jx.repack(ja, cap), rtol=0, atol=0)


@pytest.mark.parametrize("tight", [False, True])
def test_coarsen_matches_jax(tight):
    ja, ta = matrix_pair(9, 7, 8, 0.3, 23, empty_rows=(4,), pad=2)
    cap = tx.plan_coarsen(ta, 4) if tight else None
    assert tx.plan_coarsen(ta, 4) == jx.plan_coarsen(ja, 4)
    got, got_occ = tx.coarsen(ta, 4, cap=cap, track_leaves=True)
    want, want_occ = jx.coarsen(ja, 4, cap=cap, track_leaves=True)
    assert_same_matrix(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))
    assert_same_matrix(tx.coarsen(ta, 4, cap=2), jx.coarsen(ja, 4, cap=2), rtol=0, atol=0)


def test_banded_block_matrix_bit_identical_to_bench():
    import bench
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
        banded_block_matrix,
    )

    got = banded_block_matrix(300, 20, 64, seed=1, device="cpu")
    assert_same_matrix(got, bench.banded_block_matrix(300, 20, 64, seed=1), rtol=0, atol=0)


@pytest.mark.parametrize("n,b,cap", [(64, 16, None), (70, 16, 9)])
def test_eye_matches_jax(n, b, cap):
    got = tx.eye(n, b, cap=cap, device="cpu")
    assert_same_matrix(got, jx.eye(n, b, cap=cap), rtol=0, atol=0)
    np.testing.assert_array_equal(tx.to_dense(got).numpy(), np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("accum", [False, True])
def test_make_plan_matches_jax(accum):
    ja, ta = matrix_pair(6, 8, 8, 0.35, 24, empty_rows=(1,), pad=2)
    jb, tb = matrix_pair(8, 5, 8, 0.35, 25)
    jd, td = matrix_pair(6, 5, 8, 0.4, 26, pad=1)
    pc, oc = plan_spgemm(ja, jb)
    kw_j = dict(accum_ids=jd.ids, out_cap=oc + 12) if accum else {}
    kw_t = dict(accum_ids=td.ids, out_cap=oc + 12) if accum else {}
    want = jx.make_plan(ja, jb, pc + 5, **kw_j)
    got = tx.make_plan(ta, tb, pc + 5, **kw_t)
    for field in ("a_idx", "b_idx", "c_id", "total", "raw_total", "a_ids",
                  "b_ids", "out_ids", "seg", "pos_acc", "n_unique", "acc_ids"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert np_(g).dtype == np_(w).dtype, field
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=field)
    with pytest.raises(ValueError, match="sym_mirror"):
        tx.make_plan(ta, tb, pc, sym_mirror=True)
    # The norm filter: tau halfway between two neighbouring pair products.
    an2, bn2 = tx.block_frob_squared(ta), tx.block_frob_squared(tb)
    prods = np.sort(np.sqrt((an2[got.a_idx[:pc].long()] * bn2[got.b_idx[:pc].long()]).numpy()))
    k = int(np.argmax(prods[1:] / prods[:-1]))
    assert prods[k + 1] > prods[k] * (1 + 1e-5)
    tau = float(0.5 * (prods[k] + prods[k + 1]))
    want = jx.make_plan(ja, jb, pc + 5, tau=tau, filter_by_norm=True, **kw_j)
    got = tx.make_plan(ta, tb, pc + 5, tau=tau, filter_by_norm=True, **kw_t)
    for field in ("a_idx", "b_idx", "c_id", "total", "raw_total", "out_ids", "seg", "n_unique"):
        g, w = getattr(got, field), getattr(want, field)
        if g is not None:
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=field)
    assert 0 < int(got.total) < int(got.raw_total)


@pytest.mark.parametrize("args,want", [
    ((128, torch.float64, 8, 1, (4, 4)), "xla"),
    ((128, torch.float32, 8, 1, (4, 4)), "rows"),  # no pair_cap >= 1024 gate
    ((128, torch.bfloat16, 8, 1, (4, 4)), "rows"),
    ((128, torch.float32, 8, 1, None), "pallas"),
    ((256, torch.float32, 8, 1, (4, 4)), "pallas"),
    ((32, torch.float32, 8, 1, (4, 4)), "fine"),
    ((32, torch.float32, 8, 1, None), "xla"),
    ((8, torch.float32, 8, 1, (4, 4)), "xla"),
])
def test_resolve_backend(args, want):
    """Group caps take the row-group kernel only where it takes the leaf
    (b % 128 == 0, f32 or bf16), as in the reference: "fine" at b=32 and
    "xla" at b=8 or float64 whatever the group caps."""
    b, dtype, nbc, pair_cap, row_caps = args
    assert resolve_backend(b, dtype, nbc, pair_cap, row_caps=row_caps) == want
    with_groups = "groups" if b % 128 == 0 and dtype != torch.float64 else want
    assert resolve_backend(b, dtype, nbc, pair_cap, row_caps=row_caps,
                           group_caps=(2, 4, 4, 4)) == with_groups


def test_constructors_default_to_the_card():
    """Called without `device`, every constructor asks for the CUDA card;
    with no card (as here) it raises instead of building on the CPU."""
    from hierarchical_block_sparse_lib_tpu_torch.convert import (
        block_matrix_from_numpy,
        fine_flat_from_numpy,
    )
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
        banded_block_matrix,
        random_block_matrix,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default builds there")
    ids, data = np.zeros(1, np.int32), np.zeros((1, 16, 16), np.float32)
    geo = dict(n_rows=16, n_cols=16, block_size=16)
    calls = [
        lambda: tx.empty(64, 64, 16, 4),
        lambda: tx.eye(64, 16),
        lambda: tx.from_coo([0], [0], [1.0], 64, block_size=16),
        lambda: random_block_matrix(64, 16, 0.1),
        lambda: banded_block_matrix(64, 4, 16),
        lambda: block_matrix_from_numpy(ids, data, 1, **geo),
        lambda: fine_flat_from_numpy(ids, data.reshape(1, 2, 128), 1, **geo),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tx.empty(64, 64, 16, 4, device="cpu").device.type == "cpu"
