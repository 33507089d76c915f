"""Affine-operator extraction: the reference SOS recurrence as a small FIR.

The reference's filter application (src/filter.c:212-259) looks like an IIR,
but its data dependence only ever reaches *rightward* (y[j+m], y[j+m+1]) with
a per-step section index bound, so on a zero-state block it is exactly a small
ANTI-CAUSAL FIR plus affine constants:

  * rows q >= 2*sosLen are stationary: y[q] = Σ_d t[d]·x[q+d], support
    D <= ceil(sosLen/2) + 1;
  * the first 2*sosLen rows are special (partial update sets) — a tiny
    dense head matrix;
  * applyComplexFilter also *writes past its region* by up to 4*sosLen-2
    entries (tail "overrun" rows, nonstationary, and — in the -L layout —
    reading x beyond the block aliases the output's own head);
  * initial y values (the arena corruption from a previous stage) enter
    linearly: a dense y_init coupling matrix on the head rows.

Rather than hand-deriving each piece, this module *probes* the exact numpy
golden model (demodulator_tpu.oracle.ops) with batched impulses in float64
and verifies the recovered structure against the oracle on held-out random
inputs.  The result is mathematically the SAME linear map the C code
computes, evaluated as conv + two tiny matmuls — embarrassingly parallel,
elementwise and matmul work, no lax.scan.

Math note: exactness is in real arithmetic; float32 evaluation order differs
from C (≈1e-7 relative, ~140 dB SNR — far beyond the 60 dB acceptance bar).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..oracle import ops as oracle

__all__ = ["RealFirOp", "CplxFirOp", "extract_real_fir", "extract_cplx_fir"]


def _sos_key(sos: np.ndarray) -> bytes:
    return np.ascontiguousarray(np.asarray(sos, dtype=np.float64)).tobytes()


@dataclasses.dataclass(frozen=True)
class RealFirOp:
    """Affine operator equivalent of applyFilter on a zero-state block.

    apply: y[q] = head/stationary rows of x  +  Y @ y_init  (+ consts == 0)

    head    [H, Wh]  — rows 0..H-1 acting on x[0:Wh]
    taps    [D+1]    — stationary taps for rows q >= H: Σ t[d]·x[q+d]
    y_coup  [Hy, Ky] — optional coupling from initial y values (arena
                        corruption) into rows 0..Hy-1; None if unused
    """
    sos_len: int
    head: np.ndarray
    taps: np.ndarray
    y_coup: np.ndarray | None

    @property
    def H(self):
        return self.head.shape[0]

    @property
    def Wh(self):
        return self.head.shape[1]

    @property
    def D(self):
        return len(self.taps) - 1


@dataclasses.dataclass(frozen=True)
class CplxFirOp:
    """Affine operator equivalent of applyComplexFilter on a zero-state block.

    Operates per complex-sample lane (I and Q share the x-map; only affine
    constants differ).  All sizes below are in COMPLEX SAMPLES (pairs).

    head     [Hc, Whc]  — per-lane head rows on x_lane[0:Whc]
    taps     [Dc+1]     — per-lane stationary taps for rows q >= Hc
    tail     [Kc, Wtc]  — overrun rows (outputs S..S+Kc-1 for block of S
                           samples) acting on the LAST Wtc input samples
    tail_alias [Kc, Wac] — overrun-row coupling to the FIRST Wac input
                           samples (via the x-read aliasing into the output's
                           own head in the contiguous arena); zero matrix
                           when alias=False (highpassDc's separate buffer)
    const_i / const_q    — affine constants: scalar interior value plus
                           per-row head and tail vectors, per lane
    """
    sos_len: int
    alias: bool
    head: np.ndarray
    taps: np.ndarray
    tail: np.ndarray
    tail_alias: np.ndarray
    c_head_i: np.ndarray
    c_head_q: np.ndarray
    c_int_i: float
    c_int_q: float
    c_tail_i: np.ndarray
    c_tail_q: np.ndarray

    @property
    def Hc(self):
        return self.head.shape[0]

    @property
    def Whc(self):
        return self.head.shape[1]

    @property
    def Dc(self):
        return len(self.taps) - 1

    @property
    def Kc(self):
        return self.tail.shape[0]

    @property
    def Wtc(self):
        return self.tail.shape[1]


# ---------------------------------------------------------------------------
# real filter extraction
# ---------------------------------------------------------------------------

def _run_real_batch(x_cols: np.ndarray, L: int, sos64: np.ndarray,
                    y_init_cols: np.ndarray | None = None) -> np.ndarray:
    """Run the exact recurrence on a batch of probe columns at once.

    x_cols: [L + pad, B] float64.  Returns y[:L, B].
    """
    sos_len = len(sos64)
    B = x_cols.shape[1]
    ext = L + 2 * sos_len + 2
    x = np.zeros((ext, B))
    x[: x_cols.shape[0]] = x_cols[:ext]
    y = np.zeros((ext, B))
    if y_init_cols is not None:
        y[: y_init_cols.shape[0]] += y_init_cols
    oracle.apply_filter_ip(x, y, L, sos64)
    return y[:L]


def extract_real_fir(sos: np.ndarray, y_init_len: int = 0) -> RealFirOp:
    return _extract_real_fir_cached(_sos_key(sos), len(sos), y_init_len)


@lru_cache(maxsize=64)
def _extract_real_fir_cached(sos_bytes: bytes, sos_len: int,
                             y_init_len: int) -> RealFirOp:
    sos64 = np.frombuffer(sos_bytes, dtype=np.float64).reshape(sos_len, 6)
    H = 2 * sos_len
    D_max = sos_len + 4                      # generous; true D <= ceil(sL/2)+1
    G = D_max + 8
    L = H + G + D_max + 8                    # probe length

    # affine const (x = 0): must be exactly zero (+1 and -a0 cancel)
    c = _run_real_batch(np.zeros((L, 1)), L, sos64)[:, 0]
    assert np.all(c == 0.0), "real filter affine const expected zero"

    # full matrix via batched impulses
    M = _run_real_batch(np.eye(L), L, sos64)          # [L rows, L cols]

    # stationary taps from a middle row
    mid = H + D_max + 2
    taps_full = M[mid, mid: mid + D_max + 1]
    nz = np.nonzero(taps_full)[0]
    D = int(nz[-1]) if len(nz) else 0
    taps = taps_full[: D + 1].copy()
    # verify stationarity of all rows >= H (incl. boundary-adjacent ones)
    for q in range(H, L - D - 2):
        row = M[q]
        assert np.all(row[:q] == 0), f"row {q} has left support"
        np.testing.assert_allclose(row[q: q + D + 1], taps, rtol=1e-12, atol=1e-300)
        assert np.all(row[q + D + 1:] == 0)
    Wh = H + D + 1
    head = M[:H, :Wh].copy()
    assert np.all(M[:H, Wh:] == 0), "head rows exceed expected width"

    y_coup = None
    if y_init_len:
        base = _run_real_batch(np.zeros((L, 1)), L, sos64,
                               np.zeros((y_init_len, 1)))[:, 0]
        Ys = _run_real_batch(np.zeros((L, y_init_len)), L, sos64,
                             np.eye(y_init_len))
        Ys -= base[:, None]
        row_support = np.nonzero(np.any(Ys != 0, axis=1))[0]
        Hy = int(row_support[-1]) + 1 if len(row_support) else 0
        assert Hy <= y_init_len + sos_len, "y_init coupling wider than expected"
        y_coup = Ys[:Hy].copy()

    op = RealFirOp(sos_len=sos_len, head=head, taps=taps, y_coup=y_coup)

    # held-out verification at a different length
    rng = np.random.default_rng(0)
    L2 = L + 37
    xv = rng.standard_normal((L2, 3))
    yiv = rng.standard_normal((y_init_len, 3)) if y_init_len else None
    want = _run_real_batch(xv, L2, sos64, yiv)
    got = _predict_real(op, xv, yiv)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert np.max(np.abs(want - got)) < 1e-9 * scale, "real FIR extraction failed verification"
    return op


def _predict_real(op: RealFirOp, x: np.ndarray, y_init: np.ndarray | None):
    """numpy reference implementation of the extracted operator (float64)."""
    L = x.shape[0]
    D = op.D
    xp = np.concatenate([x, np.zeros((D + 1,) + x.shape[1:])], axis=0)
    y = np.zeros_like(x)
    for d in range(D + 1):
        y += op.taps[d] * xp[d: d + L]
    y[: op.H] = op.head @ xp[: op.Wh]
    if y_init is not None and op.y_coup is not None and len(op.y_coup):
        y[: op.y_coup.shape[0]] += op.y_coup @ y_init
    return y


# ---------------------------------------------------------------------------
# complex (interleaved I/Q) filter extraction
# ---------------------------------------------------------------------------

def _run_cplx_batch(x_cols: np.ndarray, L: int, sos64: np.ndarray,
                    alias: bool, y_init_cols: np.ndarray | None = None):
    """Run the exact complex recurrence on probe columns.

    x_cols: [L, B] interleaved reals.  Returns y[:L + Kc, B] where
    Kc = 4*sosLen - 2 (overrun entries included).  With alias=True, x and y
    are adjacent views of one arena (x reads past L hit y's head), matching
    the -L consumer layout; otherwise out-of-range x reads are zero
    (highpassDc's separate scratch).
    """
    sos_len = len(sos64)
    K = 4 * sos_len - 2
    B = x_cols.shape[1]
    slack = 4 * sos_len + 4
    if alias:
        arena = np.zeros((2 * L + K + slack, B))
        arena[:L] = x_cols[:L]
        x_view, y_view = arena, arena[L:]
        if y_init_cols is not None:
            y_view[: y_init_cols.shape[0]] += y_init_cols
        oracle.apply_complex_filter_ip(x_view, y_view, L, sos64)
        return y_view[: L + K].copy()
    x = np.zeros((L + slack, B))
    x[:L] = x_cols[:L]
    y = np.zeros((L + K + slack, B))
    if y_init_cols is not None:
        y[: y_init_cols.shape[0]] += y_init_cols
    oracle.apply_complex_filter_ip(x, y, L, sos64)
    return y[: L + K].copy()


def extract_cplx_fir(sos: np.ndarray, alias: bool,
                     y_init_len: int = 0):
    """Extract the complex-filter operator (+ optional y_init coupling).

    Returns (CplxFirOp, y_coup) where y_coup is None or a per-REAL-index
    coupling [rows, y_init_len] (dense, small) applied to interleaved output.
    """
    return _extract_cplx_cached(_sos_key(sos), len(sos), alias, y_init_len)


@lru_cache(maxsize=64)
def _extract_cplx_cached(sos_bytes: bytes, sos_len: int, alias: bool,
                         y_init_len: int):
    sos64 = np.frombuffer(sos_bytes, dtype=np.float64).reshape(sos_len, 6)
    K = 4 * sos_len - 2                       # overrun reals
    Hc = 2 * sos_len + sos_len + 4            # head complex samples (margin)
    Dc_max = sos_len + 4
    Wtc_max = 2 * sos_len + Dc_max + 4        # tail window, complex samples
    S = Hc + Dc_max + Wtc_max + 16            # probe length in complex samples
    L = 2 * S

    # constants per lane
    c = _run_cplx_batch(np.zeros((L, 1)), L, sos64, alias)[:, 0]
    ci, cq = c[0::2], c[1::2]

    # impulse probes on every interleaved position
    M = _run_cplx_batch(np.eye(L), L, sos64, alias) - c[:, None]

    # lanes must be independent and share the x-map
    Mi = M[0::2, 0::2]      # I rows vs I cols (complex-sample indexed)
    Mq = M[1::2, 1::2]
    assert np.all(M[0::2, 1::2] == 0) and np.all(M[1::2, 0::2] == 0), \
        "unexpected I/Q cross-coupling"
    np.testing.assert_allclose(Mi, Mq, rtol=1e-12, atol=1e-300)

    # stationary taps (complex-sample domain)
    mid = Hc + 2
    taps_full = Mi[mid, mid: mid + Dc_max + 1]
    nz = np.nonzero(taps_full)[0]
    Dc = int(nz[-1]) if len(nz) else 0
    taps = taps_full[: Dc + 1].copy()
    Kc = K // 2                               # overrun complex samples
    for q in range(Hc, S - Wtc_max - Dc - 2):
        row = Mi[q]
        assert np.all(row[:q] == 0)
        np.testing.assert_allclose(row[q: q + Dc + 1], taps, rtol=1e-12,
                                   atol=1e-300)
        assert np.all(row[q + Dc + 1:] == 0)
    Whc = Hc + Dc + 1
    head = Mi[:Hc, :Whc].copy()
    assert np.all(Mi[:Hc, Whc:] == 0)

    # overrun/tail rows: S..S+Kc-1 — split column support into a head-alias
    # window and a tail window
    tail_rows = Mi[S: S + Kc]
    Wac = Whc                                 # alias support within head cols
    tail_alias = tail_rows[:, :Wac].copy()
    tail = tail_rows[:, S - Wtc_max: S].copy()
    assert np.all(tail_rows[:, Wac: S - Wtc_max] == 0), \
        "overrun rows have mid-block support"
    if not alias:
        assert np.all(tail_alias == 0)

    # interior constant must be uniform per lane across ALL consumed rows
    # past the head (incl. the final consumed rows: their alias reads hit the
    # never-written, always-zero y head)
    c_head_i, c_head_q = ci[:Hc].copy(), cq[:Hc].copy()
    c_int_i = float(ci[Hc + 2])
    c_int_q = float(cq[Hc + 2])
    assert np.all(ci[Hc:S] == c_int_i)
    assert np.all(cq[Hc:S] == c_int_q)
    c_tail_i = ci[S:].copy()                    # overrun rows only [Kc]
    c_tail_q = cq[S:].copy()
    op = CplxFirOp(sos_len=sos_len, alias=alias, head=head, taps=taps,
                   tail=tail, tail_alias=tail_alias,
                   c_head_i=c_head_i, c_head_q=c_head_q,
                   c_int_i=c_int_i, c_int_q=c_int_q,
                   c_tail_i=c_tail_i, c_tail_q=c_tail_q)

    y_coup = None
    if y_init_len:
        base = _run_cplx_batch(np.zeros((L, 1)), L, sos64, alias,
                               np.zeros((y_init_len, 1)))[:, 0]
        Ys = _run_cplx_batch(np.zeros((L, y_init_len)), L, sos64, alias,
                             np.eye(y_init_len))
        Ys -= base[:, None]
        # coupling lands in the head rows AND (with alias) in the final
        # consumed rows + overrun rows, which read the never-written y head
        # through the x-alias (x[L+t] ↔ y[t])
        head_rows = 2 * (y_init_len + 2 * sos_len + 2)
        tail_rows = K + 4 * sos_len
        yc_head = Ys[:head_rows].copy()
        yc_tail = Ys[L - 4 * sos_len:].copy()    # [tail_rows, y_init_len]
        assert yc_tail.shape[0] == tail_rows
        assert np.all(Ys[head_rows: L - 4 * sos_len] == 0), \
            "cplx y_init coupling has unexpected mid-block support"
        y_coup = (yc_head, yc_tail)

    # held-out verification
    rng = np.random.default_rng(1)
    S2 = S + 24
    xv = rng.standard_normal((2 * S2, 3))
    yiv = rng.standard_normal((y_init_len, 3)) if y_init_len else None
    want = _run_cplx_batch(xv, 2 * S2, sos64, alias, yiv)
    got = _predict_cplx(op, xv, y_coup, yiv)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert np.max(np.abs(want - got)) < 1e-9 * scale, \
        "cplx FIR extraction failed verification"
    return op, y_coup


def _predict_cplx(op: CplxFirOp, x: np.ndarray, y_coup, y_init):
    """numpy float64 reference of the extracted complex operator.

    x: [2S, B] interleaved.  Returns [2S + 2*Kc, B] interleaved.
    """
    L = x.shape[0]
    S = L // 2
    B = x.shape[1] if x.ndim > 1 else 1
    xl = x.reshape(S, 2, -1)                  # [S, lane, B]
    Dc = op.Dc
    xp = np.concatenate([xl, np.zeros((Dc + 1, 2, xl.shape[2]))], axis=0)
    y = np.zeros((S + op.Kc, 2, xl.shape[2]))
    for d in range(Dc + 1):
        y[:S] += op.taps[d] * xp[d: d + S]
    y[: op.Hc] = np.einsum('hw,wlb->hlb', op.head, xp[: op.Whc])
    y[S:] = (np.einsum('kw,wlb->klb', op.tail, xl[S - op.Wtc:])
             + np.einsum('kw,wlb->klb', op.tail_alias, xp[: op.Whc]))
    y[: op.Hc, 0] += op.c_head_i[:, None]
    y[: op.Hc, 1] += op.c_head_q[:, None]
    y[op.Hc: S, 0] += op.c_int_i
    y[op.Hc: S, 1] += op.c_int_q
    y[S:, 0] += op.c_tail_i[:, None]
    y[S:, 1] += op.c_tail_q[:, None]
    out = y.reshape(2 * (S + op.Kc), -1)
    if y_init is not None and y_coup is not None:
        yc_head, yc_tail = y_coup
        out[: yc_head.shape[0]] += yc_head @ y_init
        out[2 * S - 4 * op.sos_len:] += yc_tail @ y_init
    return out
