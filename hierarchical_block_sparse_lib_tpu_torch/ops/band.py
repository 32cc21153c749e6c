"""Dense-band tier (port of ``ops/band.py``): strip-panel storage for
banded matrices.

- **Storage**: row strips of 128, each a dense panel
  ``panels[s] = A[128s : 128s+128, 128s-wpad : 128s+128+wpad]``; the
  only zeros kept are the parallelogram corners.
- **Multiply**: C's strip s needs B's rows ``128s-wa .. 128s+128+wa``,
  a stack of statically shifted slices of B's own panels.  The shifts are
  the same for every strip, so the window is built by slice copies (no
  gather), and the product is ONE batched `torch.bmm` over the strips.
- **Output**: lands in panel form with halfwidth wa+wb, ready to feed
  another multiply.

`band_from_blocks`/`band_to_blocks` convert at the boundary; the honest
leaf-granularity multiply count still comes from the fine BlockMatrix
plan (`band_pair_count` gives the structural count the tier performs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import matmul_precision

STRIP = 128  # strip height


def _wpad(w: int) -> int:
    """Stored half-window: w rounded up to 64, so the panel width
    128 + 2*wpad is a multiple of 128."""
    return -(-max(w, 1) // 64) * 64


@dataclass(frozen=True)
class BandMatrix:
    """A banded n x n matrix (|i-j| <= w) as dense row-strip panels.

    ``panels[s, i, j] = A[128s + i, 128s - wpad + j]`` (zero outside the
    matrix and outside the band).  ``w`` is the true halfwidth; ``wpad``
    the stored (64-aligned) half-window.
    """

    panels: torch.Tensor  # dtype[S, 128, 128 + 2*wpad]
    n: int = 0
    w: int = 0

    @property
    def strips(self) -> int:
        return self.panels.shape[0]

    @property
    def wpad(self) -> int:
        return (self.panels.shape[2] - STRIP) // 2

    @property
    def width(self) -> int:
        return self.panels.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.panels.dtype

    @property
    def device(self) -> torch.device:
        return self.panels.device

    def col0(self, s: int) -> int:
        """Global column of panel s's first stored column."""
        return STRIP * s - self.wpad

    def __repr__(self):  # pragma: no cover - debug aid
        return (
            f"BandMatrix(n={self.n}, w={self.w}, wpad={self.wpad}, "
            f"S={self.strips}, dtype={self.dtype}, device={self.device})"
        )


def band_from_blocks(a: BlockMatrix, w: int) -> BandMatrix:
    """Extract the band |i-j| <= w of a BlockMatrix into panel form.

    Boundary conversion: the element positions are computed from the ids
    and the blocks land with ONE `index_put_`.  Entries outside the stored
    window, of padding blocks, and rows past the last strip go to a
    trash element that is dropped; entries outside |i-j| <= wpad must be
    zero (true for any matrix whose support is within the band)."""
    if a.n_rows != a.n_cols:
        raise ValueError("band tier is square-only")
    n, bb = a.n_rows, a.block_size
    if STRIP % bb and bb % STRIP:
        raise ValueError(f"block_size {bb} must divide or be divided by 128")
    wp = _wpad(w)
    W = STRIP + 2 * wp
    S = -(-n // STRIP)
    dev = a.device
    nbc = a.nb_cols
    ids = a.ids.long()
    r0 = (ids // nbc) * bb  # first row of each block
    c0 = (ids % nbc) * bb
    ar = torch.arange(bb, device=dev)
    rows = r0[:, None] + ar[None, :]  # [cap, bb]
    s = rows // STRIP
    # Stored column of element (row, c) in its row's strip window.
    cols = c0[:, None, None] + ar[None, None, :] - (s * STRIP - wp)[:, :, None]
    ok = (
        a.valid_mask()[:, None, None]
        & (rows < S * STRIP)[:, :, None]
        & (cols >= 0)
        & (cols < W)
    )
    flat = torch.where(ok, rows[:, :, None] * W + cols, S * STRIP * W)
    out = torch.zeros(S * STRIP * W + 1, dtype=a.dtype, device=dev)
    out.index_put_((flat.reshape(-1),), a.data.reshape(-1))
    return BandMatrix(panels=out[:-1].reshape(S, STRIP, W), n=n, w=w)


def band_probe(a: BlockMatrix, min_fill: float = 0.5) -> int | None:
    """Host-side structure probe: if `a` is a dense-enough band, return
    the element bandwidth `w` to pack it with (`band_from_blocks(a, w)`);
    else None.

    Gates: square; block_size divides 128; the band support fill is at
    least `min_fill` (the tier computes dense strips); the padded window
    stays below the matrix order (else the "band" is just dense).  One
    pass over the id array on the host."""
    if a.n_rows != a.n_cols or STRIP % a.block_size != 0:
        return None
    ids = a.ids.cpu().numpy().astype(np.int64)
    ids = ids[ids != int(SENTINEL)]
    if ids.size == 0:
        return None
    br, bc = ids // a.nb_cols, ids % a.nb_cols
    wb = int(np.abs(br - bc).max())
    bb = a.block_size
    w = wb * bb + bb - 1
    if 2 * _wpad(w) + STRIP >= a.n_rows:
        return None  # window ~ the whole matrix: not a band
    nb = a.nb_rows
    band_blocks = nb * (2 * wb + 1) - wb * (wb + 1)
    if ids.size < min_fill * band_blocks:
        return None
    return w


def band_pair_count(nb: int, wb: int) -> int:
    """Structural block-pair count of a full band of block-halfwidth `wb`
    on an nb x nb block grid: the work the band tier performs, reported
    as the block-multiply counter for band-routed multiplies."""
    k = np.arange(nb)
    cnt = np.minimum(nb - 1, k + wb) - np.maximum(0, k - wb) + 1
    return int((cnt * cnt).sum())


def _band_mask(wpad: int, w: int, device) -> torch.Tensor:
    """bool[128, 128 + 2*wpad]: the panel entries with |i-j| <= w."""
    i = torch.arange(STRIP, device=device)[:, None]
    j = torch.arange(STRIP + 2 * wpad, device=device)[None, :]
    return (j - wpad - i).abs() <= w


def band_from_dense(d, w: int) -> BandMatrix:
    """Extract the band of a dense [n, n] tensor (test/oracle helper)."""
    d = d if isinstance(d, torch.Tensor) else torch.as_tensor(np.asarray(d))
    n = d.shape[0]
    wp = _wpad(w)
    W = STRIP + 2 * wp
    S = -(-n // STRIP)
    # Rows padded to S strips; columns shifted right by wp with slack.
    pad = torch.zeros((S * STRIP, wp + n + W), dtype=d.dtype, device=d.device)
    pad[:n, wp : wp + n] = d
    rows = pad.reshape(S, STRIP, -1)
    win = torch.stack([rows[s, :, s * STRIP : s * STRIP + W] for s in range(S)])
    return BandMatrix(panels=win * _band_mask(wp, w, d.device), n=n, w=w)


def band_to_dense(a: BandMatrix) -> torch.Tensor:
    """Densify (test/oracle helper)."""
    S, W, wp = a.strips, a.width, a.wpad
    out = torch.zeros((S * STRIP, S * STRIP + W), dtype=a.dtype, device=a.device)
    for s in range(S):
        out[s * STRIP : (s + 1) * STRIP, s * STRIP : s * STRIP + W] = a.panels[s]
    # Stored col j of strip s is global col 128s - wp + j: shift left wp.
    return out[: a.n, wp : wp + a.n]


def band_to_blocks(
    a: BandMatrix, block_size: int = 128, cap: int | None = None
) -> BlockMatrix:
    """Convert to the canonical BlockMatrix (boundary conversion).

    Emits every block intersecting |i-j| <= w (the structural band
    support, as assembly of the band's COO would give); `truncate`
    afterwards drops numerically-zero blocks."""
    n, bb, w = a.n, block_size, a.w
    if STRIP % bb:
        raise ValueError("block_size must divide 128")
    wp = a.wpad
    nb = -(-n // bb)
    ids_l = []
    for br in range(nb):
        lo = max(0, br * bb - w) // bb
        hi = min(n - 1, br * bb + bb - 1 + w) // bb
        ids_l.extend(br * nb + bc for bc in range(lo, hi + 1))
    ids_np = np.asarray(ids_l, np.int64)
    n_out = ids_np.size
    cap = n_out if cap is None else cap
    # Block (br, bc) lives in strip s = br*bb // 128 at local rows
    # br*bb - 128s and columns bc*bb - col0(s): one gather of index grids.
    brs, bcs = ids_np // nb, ids_np % nb
    ss = (brs * bb) // STRIP
    ro = brs * bb - ss * STRIP
    co = bcs * bb - (ss * STRIP - wp)
    ii = ro[:, None, None] + np.arange(bb)[None, :, None]  # [n_out, bb, 1]
    jj = co[:, None, None] + np.arange(bb)[None, None, :]  # [n_out, 1, bb]
    ok = (jj >= 0) & (jj < a.width)
    jj_c = np.clip(jj, 0, a.width - 1)
    dev = a.device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    data = a.panels[t(ss)[:, None, None], t(ii), t(jj_c)] * t(ok).to(a.dtype)
    ids = torch.full((cap,), SENTINEL, dtype=torch.int32, device=dev)
    dat = torch.zeros((cap, bb, bb), dtype=a.dtype, device=dev)
    ids[:n_out] = t(ids_np.astype(np.int32))
    dat[:n_out] = data
    return BlockMatrix(
        ids=ids, data=dat,
        nnz=torch.tensor(n_out, dtype=torch.int32, device=dev),
        n_rows=n, n_cols=n, block_size=bb,
    )


def _add_shifted(dst, src, delta: int, rows: slice, cols: slice, at_rows: slice,
                 at_cols: slice) -> None:
    """dst[s, at_rows, at_cols] += src[s + delta, rows, cols] for every
    strip s with s + delta in range (the others take zero panels)."""
    S = src.shape[0]
    lo, hi = max(0, -delta), min(S, S - delta)
    if lo < hi:
        dst[lo:hi, at_rows, at_cols] += src[lo + delta : hi + delta, rows, cols]


def band_mm(
    a: BandMatrix,
    b: BandMatrix,
    alpha=1.0,
    precision: str = "highest",
    out_w: int | None = None,
) -> BandMatrix:
    """C = alpha * A @ B for banded A, B: ONE batched dense GEMM.

    C's halfwidth is w_a + w_b (band fill-in), clamped to `out_w` if
    given (entries beyond out_w are *discarded*: the band analogue of
    truncation with a structural threshold).

    The B window of C's strip s stacks statically shifted slices of B's
    panels (the same shifts for every strip), so the symbolic phase is
    host arithmetic and the device runs slice copies and one `bmm`."""
    if a.n != b.n:
        raise ValueError("dimension mismatch")
    wa, wb = a.wpad, b.wpad
    wc_true = a.w + b.w
    if out_w is not None:
        wc_true = min(wc_true, out_w)
    wc = min(_wpad(wc_true), wa + wb)
    Wc = STRIP + 2 * wc
    Wa = STRIP + 2 * wa
    S = a.strips
    acc = torch.promote_types(a.dtype, torch.float32)

    # Window rows: global [128s - wa, 128s + 128 + wa).  Panel s+delta of
    # B holds rows [128(s+delta), +128), window-local rows from
    # 128*delta + wa, clipped to [0, Wa).
    win = torch.zeros((S, Wa, Wc), dtype=acc, device=b.device)
    bp = b.panels.to(acc)
    d_lo = -(-wa // STRIP)  # ceil
    for delta in range(-d_lo, d_lo + 1):
        r0 = delta * STRIP + wa  # window-local first row of this panel
        src_lo, src_hi = max(0, -r0), min(STRIP, Wa - r0)
        if src_lo >= src_hi:
            continue
        # Window cols start at global 128s - wc; panel s+delta's cols at
        # global 128(s+delta) - wb: local offset c0.
        c0 = delta * STRIP + wc - wb
        csrc_lo, csrc_hi = max(0, -c0), min(b.width, Wc - c0)
        if csrc_lo >= csrc_hi:
            continue
        _add_shifted(
            win, bp, delta, slice(src_lo, src_hi), slice(csrc_lo, csrc_hi),
            slice(r0 + src_lo, r0 + src_hi), slice(c0 + csrc_lo, c0 + csrc_hi),
        )

    # A's panel column j and the window's row j are the same global column
    # 128s - wa + j: A's panels are already the left operand.
    with matmul_precision(precision, a.device):
        out = torch.bmm(a.panels.to(acc), win)
    if not (isinstance(alpha, (int, float)) and float(alpha) == 1.0):
        out = out * basic._scalar(alpha, out)
    out = out.to(a.dtype)
    if wc_true < a.w + b.w:
        # out_w below the natural fill-in: discard the entries past the
        # clamp (genuine nonzero products).  Without the clamp no mask is
        # needed: the operands are zero outside their bands, so every
        # out-of-band output entry is a sum of exact zeros.
        out = torch.where(_band_mask(wc, wc_true, out.device)[None], out, 0)
    return BandMatrix(panels=out, n=a.n, w=wc_true)


def band_add(a: BandMatrix, b: BandMatrix, alpha=1.0, beta=1.0) -> BandMatrix:
    """alpha*A + beta*B (result halfwidth max(wa, wb))."""
    if a.n != b.n:
        raise ValueError("dimension mismatch")
    if a.wpad < b.wpad:
        a, b = b, a
        alpha, beta = beta, alpha
    d = a.wpad - b.wpad
    pb = torch.nn.functional.pad(b.panels, (d, d))
    acc = torch.promote_types(a.dtype, torch.float32)
    x, y = a.panels.to(acc), pb.to(acc)
    out = (x * basic._scalar(alpha, x) + y * basic._scalar(beta, y)).to(a.dtype)
    return BandMatrix(panels=out, n=a.n, w=max(a.w, b.w))


def band_scale(a: BandMatrix, alpha) -> BandMatrix:
    return BandMatrix(panels=a.panels * basic._scalar(alpha, a.panels), n=a.n, w=a.w)


def band_frob_squared(a: BandMatrix) -> torch.Tensor:
    """Panels partition the matrix rows, so nothing is counted twice."""
    x = a.panels.to(torch.float32)
    return torch.sum(x * x)


def band_trace(a: BandMatrix) -> torch.Tensor:
    # The diagonal of strip s sits at panel cols wpad + i.
    i = torch.arange(STRIP, device=a.device)
    return torch.sum(a.panels[:, i, a.wpad + i].to(torch.float32))


def band_transpose(a: BandMatrix) -> BandMatrix:
    """A^T: entry (i, j) -> (j, i).  Panel-local: target strip s stores
    (128s+i, 128s-wp+j) = source (128s-wp+j, 128s+i), which lives in
    source strips s-1..s+1: the same static-shift stack as band_mm."""
    wp, W = a.wpad, a.width
    d_lo = -(-wp // STRIP)
    out = torch.zeros_like(a.panels)
    src = a.panels.transpose(1, 2)  # [S, c, r]
    for delta in range(-d_lo, d_lo + 1):
        # Source strip s+delta row r (global 128(s+delta)+r) becomes target
        # col j = 128*delta + wp + r; source col c (global 128(s+delta) -
        # wp + c) becomes target row i = 128*delta - wp + c.
        j0 = delta * STRIP + wp
        i0 = delta * STRIP - wp
        r_lo, r_hi = max(0, -j0), min(STRIP, W - j0)
        c_lo, c_hi = max(0, -i0), min(W, STRIP - i0)
        if r_lo >= r_hi or c_lo >= c_hi:
            continue
        _add_shifted(
            out, src, delta, slice(c_lo, c_hi), slice(r_lo, r_hi),
            slice(i0 + c_lo, i0 + c_hi), slice(j0 + r_lo, j0 + r_hi),
        )
    return BandMatrix(panels=out, n=a.n, w=a.w)
