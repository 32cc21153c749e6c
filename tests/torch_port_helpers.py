"""Shared inputs and comparisons for the tests that hold the PyTorch port
(`hierarchical_block_sparse_lib_tpu_torch`) against the JAX package.

Inputs are made once with numpy from a seed and handed to both packages,
so they are bit-identical on either side.
"""

from __future__ import annotations

import contextlib

import numpy as np
import jax.numpy as jnp
import torch

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu_torch.convert import (
    block_matrix_from_numpy,
    fine_flat_from_numpy,
    to_numpy,
)

SENTINEL = np.int32(np.iinfo(np.int32).max)


def random_blocks(nbr, nbc, b, density, seed, empty_rows=(), pad=0):
    """Sorted ids and N(0,1) blocks of a random nbr x nbc block pattern;
    block rows in `empty_rows` are empty; `pad` SENTINEL/zero slots are
    appended (capacity above nnz)."""
    rng = np.random.default_rng(seed)
    n_blocks = max(1, int(round(density * nbr * nbc)))
    ids = np.sort(rng.choice(nbr * nbc, n_blocks, replace=False))
    ids = ids[~np.isin(ids // nbc, empty_rows)].astype(np.int32)
    data = rng.standard_normal((ids.size, b, b)).astype(np.float32)
    nnz = ids.size
    ids = np.concatenate([ids, np.full(pad, SENTINEL, np.int32)])
    data = np.concatenate([data, np.zeros((pad, b, b), np.float32)])
    return ids, data, nnz


def matrix_pair(nbr, nbc, b, density, seed, empty_rows=(), pad=0):
    """(JAX BlockMatrix, port BlockMatrix) of the same random input."""
    ids, data, nnz = random_blocks(nbr, nbc, b, density, seed, empty_rows, pad)
    geo = dict(n_rows=nbr * b, n_cols=nbc * b, block_size=b)
    jm = jx.BlockMatrix(
        ids=jnp.asarray(ids), data=jnp.asarray(data),
        nnz=jnp.asarray(nnz, jnp.int32), **geo,
    )
    return jm, block_matrix_from_numpy(ids, data, nnz, **geo, device="cpu")


def to_port(m):
    """A JAX BlockMatrix or FineFlat as the port's counterpart."""
    fields = to_numpy(m)
    if isinstance(m, jx.FineFlat):
        return fine_flat_from_numpy(**fields, device="cpu")
    return block_matrix_from_numpy(**fields, device="cpu")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_matrix(port_m, jax_m, rtol=1e-5, atol=1e-5):
    """Ids, nnz and geometry exactly; payloads within the tolerance."""
    np.testing.assert_array_equal(np_(port_m.ids), np_(jax_m.ids))
    assert int(port_m.nnz) == int(jax_m.nnz)
    assert (port_m.n_rows, port_m.n_cols, port_m.block_size) == (
        jax_m.n_rows, jax_m.n_cols, jax_m.block_size,
    )
    np.testing.assert_allclose(
        np_(port_m.data), np_(jax_m.data), rtol=rtol, atol=atol
    )


# Kernel-module tolerances.  "highest"/"high": f32 sums taken in another
# order.  "default": both packages round the same alpha*A and B to bf16
# and take exact f32 products; only the summation order differs.
FINE_TOL = {"highest": 1e-5, "high": 1e-5, "default": 1e-4}


def check_fine_spgemm(b, precision, layout="flat"):
    """The port's fine_spgemm (on the CPU: its plain version) against the
    JAX kernel in interpret mode, on rectangular operands with empty rows,
    alpha = -0.5 and three tail slots past the product support."""
    from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_fine import (
        fine_spgemm as jax_fine_spgemm,
    )
    from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
        fine_spgemm,
    )

    ja, ta = matrix_pair(8, 12, b, 0.3, b, empty_rows=(1, 5), pad=2)
    jb, tb = matrix_pair(12, 6, b, 0.3, b + 1, empty_rows=(2,))
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, jb)
    out_cap = oc + 3
    plan = jx.make_fine_plan(ja, jb, pc, out_cap, (mbr, mcr))
    if layout == "flat":
        ja_data, jb_data = jx.fine_pack(ja).data, jx.fine_pack(jb).data
    else:
        ja_data, jb_data = ja.data, jb.data
    args = (ja.nb_rows, jb.nb_rows, jb.nb_cols, out_cap, mbr, mcr)
    kw = dict(precision=precision, block_size=b, out_layout=layout, alpha=-0.5)
    want = np.asarray(
        jax_fine_spgemm(ja.ids, ja_data, jb.ids, jb_data, plan.out_ids, *args, **kw)
    )
    got = fine_spgemm(
        ta.ids, torch.from_numpy(np.array(ja_data)), tb.ids,
        torch.from_numpy(np.array(jb_data)),
        torch.from_numpy(np.array(plan.out_ids)), *args, **kw,
    ).numpy()
    assert got.shape == want.shape
    tol = FINE_TOL[precision]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not np.any(got[oc:]) and not np.any(want[oc:])  # zero tail


def assert_same_info(port_info, jax_info):
    """Every MultiplyInfo counter and flag exactly."""
    for field in (
        "n_block_pairs", "n_out_blocks", "pair_overflow", "out_overflow",
        "row_overflow", "plan_mismatch", "n_leaf_multiplies",
    ):
        got = np_(getattr(port_info, field))
        want = np_(getattr(jax_info, field))
        assert got.dtype.kind == want.dtype.kind, field
        assert got == want, (field, got, want)


# Row-panel kernel module vs JAX, relative to max|C|: f32 sums taken in
# another order.  At "default" JAX's interpret mode does not round the
# operands to bf16 (the TPU's matrix unit does; the port does), so JAX is
# handed the bf16-rounded operands: both then sum exact f32 products.
ROWS_TOL = 1e-5


def check_rows_spgemm(b, precision, option=None, nb=(5, 7, 4)):
    """The port's rows_spgemm (on the CPU: its plain version) against the
    JAX kernel in interpret mode, on rectangular operands with empty rows.
    The output ids are the product support united with two ids of A's
    empty row 1 (slots no product reaches) plus three tail slots.
    `option` is None, "filter", "triu" or "acc"."""
    import jax.numpy as jnp

    from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_rows import (
        rows_spgemm as jax_rows_spgemm,
    )
    from hierarchical_block_sparse_lib_tpu.ops.basic import union_merge
    from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
        rows_spgemm,
    )

    nbr, nbk, nbc = nb
    ja, ta = matrix_pair(nbr, nbk, b, 0.4, 40 + b, empty_rows=(1,), pad=2)
    jb, tb = matrix_pair(nbk, nbc, b, 0.4, 41 + b, empty_rows=(2,))
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, jb)
    sym = jx.spgemm_symbolic(ja, jb, pc)
    extra = jnp.asarray([nbc, nbc + 2], jnp.int32)  # (1, 0) and (1, 2)
    out_cap = oc + 2 + 3
    out_ids = union_merge(sym[2], extra, out_cap)[0]
    kw = {}
    if option == "filter":
        an2 = np.sum(np.asarray(ja.data, np.float32) ** 2, axis=(1, 2))
        bn2 = np.sum(np.asarray(jb.data, np.float32) ** 2, axis=(1, 2))
        prods = np.sort(an2[np.asarray(sym[0])[:pc]] * bn2[np.asarray(sym[1])[:pc]])
        # The cut: the gap nearest the median wider than 1e-3, so no pair
        # lies near it (wide leaves' norms bunch: at b = 256 the median gap
        # can be narrower).
        gaps = np.nonzero(prods[1:] > prods[:-1] * (1 + 1e-3))[0] + 1
        assert gaps.size
        m = int(gaps[np.argmin(np.abs(gaps - len(prods) // 2))])
        kw = dict(a_norms2=an2, b_norms2=bn2, tau2=np.float32(0.5 * (prods[m - 1] + prods[m])))
    elif option == "triu":
        kw = dict(triu=True)
    elif option == "acc":
        rng = np.random.default_rng(b)
        kw = dict(acc_data=rng.standard_normal((out_cap, b, b)).astype(np.float32))
    geo = (ja.nb_rows, jb.nb_rows, jb.nb_cols, out_cap, mbr, mcr)
    ja_data, jb_data = ja.data, jb.data
    if precision == "default":
        ja_data, jb_data = (
            x.astype(jnp.bfloat16).astype(jnp.float32) for x in (ja.data, jb.data)
        )
    want = np.asarray(jax_rows_spgemm(
        ja.ids, ja_data, jb.ids, jb_data, out_ids, *geo, precision=precision,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
    ))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "tau2" in tkw:
        tkw["tau2"] = float(kw["tau2"])
    got = rows_spgemm(
        ta.ids, ta.data, tb.ids, tb.data, torch.from_numpy(np.array(out_ids)),
        *geo, precision=precision, **tkw,
    ).numpy()
    assert got.shape == want.shape == (out_cap, b, b)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= ROWS_TOL, (precision, err)
    ids = np.asarray(out_ids)
    start = kw.get("acc_data", np.zeros_like(got))
    union = np.isin(ids, np.asarray(extra))
    np.testing.assert_array_equal(got[union], start[union])  # no product
    assert not np.any(got[ids == SENTINEL])  # zero tail
    if option == "filter":  # the skip really dropped pairs
        full = rows_spgemm(
            ta.ids, ta.data, tb.ids, tb.data, torch.from_numpy(np.array(out_ids)),
            *geo, precision=precision,
        ).numpy()
        assert np.abs(full - got).max() > 1e-3 * scale
    return got, want


def aligned_case(b, nb=8, seed=5):
    """A random nb x nb block pattern at density 1/3 (the reference test's)
    and an accumulator D with exactly the support of A @ A: (JAX A, port
    A, JAX D, port D, (pair_cap, out_cap, row_caps))."""
    import dataclasses

    from hierarchical_block_sparse_lib_tpu.ops import spgemm as jsp

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


# The JAX micro-benchmark scripts turn on a persistent compilation cache
# when they are imported (scripts/micro_fine_kernel.py:29-31).
JAX_CACHE_SETTINGS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


def import_jax_script(name: str):
    """Import ``scripts/<name>.py`` (a JAX script) and give JAX's
    compilation-cache settings back as they were before the import."""
    import importlib
    import os
    import sys

    import jax

    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_SETTINGS}
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    sys.path.insert(0, path)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(path)
        for k, v in saved.items():
            jax.config.update(k, v)


def interpret_zero():
    """TPU interpret mode with scratch memory zeroed: the micro scripts'
    kernels read scratch they never initialise (`micro`'s accumulator)."""
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero"))


def bf16_rounded(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even) and back to f32.  JAX's
    interpret mode takes "default" products in f32; the TPU's matrix unit
    and the port round the operands to bf16 first, so JAX is handed them
    rounded."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()


def rel_to_max(got, want) -> float:
    """max|got - want| / max|want| (the difference alone when want is 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    diff = np.abs(got - want).max()
    return float(diff / scale) if scale else float(diff)


def assert_same_plan(port_plan, jax_plan):
    """Every field of a host plan (a dataclass of arrays, ints and tuples
    of either), in the port's and the JAX package's form, exactly equal."""
    import dataclasses

    def same(got, want, name):
        if isinstance(want, (tuple, list)):
            assert len(got) == len(want), name
            for k, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"{name}[{k}]")
        elif dataclasses.is_dataclass(want):
            assert_same_plan(got, want)
        elif isinstance(want, (int, float, np.integer)) and not isinstance(want, bool):
            assert got == want, (name, got, want)
        else:
            g, w = np_(got), np.asarray(want)
            assert g.shape == w.shape, (name, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=name)

    assert type(port_plan).__name__ == type(jax_plan).__name__
    for f in dataclasses.fields(jax_plan):
        same(getattr(port_plan, f.name), getattr(jax_plan, f.name), f.name)


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with `n` torch intra-op threads, then restore the
    count.  The distributed tests run thousands of tiny ops; with the
    suite's parallel workers each spinning up every core's worth of
    threads, they took 198 s instead of 30 s on 8 cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def mix_dense(n, b, seed, extra):
    """A dense band of half-width 2b plus `extra` random blocks: the B5
    structure (band + random sprinkle) at test size."""
    from hierarchical_block_sparse_lib_tpu.utils import generators as jgen

    rng = np.random.default_rng(seed)
    r, c, v = jgen.banded_coo(n, 2 * b, seed=seed)
    d = jgen.dense_oracle(r, c, v, n)
    nb = n // b
    for _ in range(extra):
        i, j = rng.integers(0, nb, 2)
        d[i * b:(i + 1) * b, j * b:(j + 1) * b] = rng.standard_normal((b, b)).astype(np.float32) * 0.1
    return d


def purifiable(d):
    """A symmetric iterate with its spectrum inside [0, 1]."""
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    return np.eye(d.shape[0], dtype=np.float32) * 0.55 - ds


def assert_matches_single(yd, want_m, tol=1e-5):
    """A distributed matrix gathered back against a single-device one:
    the same stored ids, data within `tol` of max|want|."""
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist

    got = dist.undistribute(yd)
    n = int(want_m.nnz)
    assert int(got.nnz) == n
    np.testing.assert_array_equal(got.ids[:n].numpy(), np.asarray(want_m.ids)[:n])
    assert rel_to_max(got.data[:n].numpy(), np.asarray(want_m.data)[:n]) <= tol
