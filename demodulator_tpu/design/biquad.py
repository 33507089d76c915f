"""Host-side IIR biquad (second-order-section) designer.

Re-derives, from the analog prototype + bilinear transform, the exact SOS
coefficient tables the reference computes at startup (reference:
src/filter.c:22-210, dispatcher src/matrix.c:25-80).  This runs once per
pipeline construction on the host in ``np.longdouble`` (x87 80-bit on
x86-64 Linux, matching the reference's ``LREAL = long double``), and the
result is cast down to the compute dtype exactly once — mirroring
src/matrix.c:75-79.  The coefficients then become jit-time constants of the
device pipeline.

Design modes (reference src/matrix.c:48-73):
    0 — lowpass Butterworth
    1 — lowpass Chebyshev type I
    2 — highpass Butterworth
    3 — highpass Chebyshev type I

An SOS row is ``[b0, b1, b2, a0, a1, a2]``.  NOTE: the reference's
*application* of these rows is nonstandard (see demodulator_tpu.ops.fir);
this module only reproduces the coefficient values.
"""
from __future__ import annotations

import numpy as np

LREAL = np.longdouble

__all__ = [
    "design_sos",
    "sos_section_count",
    "BUTTER_LP",
    "CHEBY1_LP",
    "BUTTER_HP",
    "CHEBY1_HP",
]

BUTTER_LP = 0
CHEBY1_LP = 1
BUTTER_HP = 2
CHEBY1_HP = 3


def sos_section_count(degree: int) -> int:
    """Number of SOS rows for a given filter order (⌈degree/2⌉).

    Mirrors src/matrix.c:195-200.
    """
    return (degree >> 1) + (degree & 1)


def _warp_butter(alpha: LREAL, beta: LREAL, k: int, n: int):
    """k-th bilinear-transformed Butterworth pole (src/filter.c:22-40).

    Returns ``(zr, pole_re, pole_im)`` where the *stored* pole is
    ``(1 - zr, ±zj)`` and ``zr`` feeds the gain accumulator.
    """
    w = LREAL(np.pi) / 2 * (LREAL(1) / LREAL(n) * (LREAL(-1) + LREAL(2 * k)) + 1)
    a = np.cos(w)
    d = LREAL(1) / (a - alpha)
    zr = (-beta + a) * d
    zj = np.sin(w) * d
    return zr, -zr + 1, zj


def _warp_cheby1(tng: LREAL, ep: LREAL, k: int, n: int):
    """k-th bilinear-transformed Chebyshev-I pole (src/filter.c:60-83)."""
    one_over_n = LREAL(1) / LREAL(n)
    ten = LREAL(10)
    v = np.log((LREAL(1) + ten ** (LREAL(0.5) * ep)) / np.sqrt(LREAL(-1) + ten ** ep)) * one_over_n
    t = LREAL(np.pi) / 2 * (one_over_n * (LREAL(-1) + LREAL(2 * k)))
    a = np.cos(t) * np.cosh(v) * tng
    b = np.sin(t) * np.sinh(v) * tng
    c = a * a + b * b
    d = LREAL(1) / (LREAL(1) + c + LREAL(2) * b)
    zj = LREAL(2) * a * d
    zr = LREAL(2) * (b + c) * d
    return zr, -zr + 1, zj


def _zp2sos(n: int, zero: LREAL, p: np.ndarray, k: LREAL) -> np.ndarray:
    """Pair conjugate poles/zeros into SOS rows (src/filter.c:104-140).

    ``p`` is the flat stride-4 pole array [(re, im, re, -im), ...]; all ``n``
    zeros sit at ``zero`` (∓1).  Gain ``k`` is folded into the b-row of the
    *last* section (src/filter.c:137-139).
    """
    npc = n >> 1
    is_odd = n & 1
    last = npc if is_odd else npc - 1
    sos = np.zeros((sos_section_count(n), 6), dtype=LREAL)

    for j in range(npc):
        i = 4 * j
        sos[j][0] = 1
        sos[j][1] = -2 * zero
        sos[j][2] = zero * zero  # z[i]^2 + z[i+1]^2 with z[i+1] = 0
        sos[j][3] = 1
        sos[j][4] = -2 * p[i]
        sos[j][5] = p[i] * p[i] + p[i + 1] * p[i + 1]

    if is_odd:
        # First-order tail section: real pole at p[2n-2] (src/filter.c:124-130)
        sos[npc][0] = 1
        sos[npc][1] = -zero
        sos[npc][2] = 0
        sos[npc][3] = 1
        sos[npc][4] = -p[(n << 1) - 2]
        sos[npc][5] = 0
    else:
        # Redundant rewrite of sos[0][1] in the reference (src/filter.c:131-135);
        # value is identical since every zero is the same.
        sos[0][0] = 1
        sos[0][2] = 1
        sos[0][1] = -2 * zero

    sos[last][0] *= k
    sos[last][1] *= k
    sos[last][2] *= k
    return sos


def _transform_bilinear(n: int, alpha: LREAL, beta: LREAL, is_highpass: bool,
                        warp, is_cheby_lp: bool, reflect_gain: bool) -> np.ndarray:
    """Generate bilinear-transform pole set + gain and form SOS rows.

    Mirrors src/filter.c:142-210.  The gain accumulator multiplies |p_k|^2
    for conjugate pairs and the (complex) last pole for odd n, seeded with
    1/sqrt(2) for even-order lowpass Chebyshev (src/filter.c:150-153), then
    divides by 2^n.  Only highpass *Butterworth* reflects the returned zr to
    2 - zr before accumulation (src/filter.c:42-50); highpass Chebyshev
    instead inverts tan upstream (src/filter.c:95-101).  The stored pole is
    1 - zr either way.
    """
    is_odd = n & 1
    is_cheby_even = (not is_odd) and is_cheby_lp
    acc_re = np.sqrt(LREAL(0.5)) if is_cheby_even else LREAL(1)
    acc_im = LREAL(0)
    num_pairs = sos_section_count(n)
    p = np.zeros(4 * (n + 1), dtype=LREAL)

    for k in range(1, num_pairs + 1):
        zr, pre, pim = warp(alpha, beta, k, n)
        if reflect_gain:
            zr = 2 - zr  # warpButterHp return path (src/filter.c:42-50)
        j = (k - 1) << 2
        p[j] = p[j + 2] = pre
        p[j + 1] = pim
        p[j + 3] = -pim
        zj = pim
        if k <= n >> 1:
            a = zr * zr + zj * zj
            acc_re *= a
            acc_im *= a
        else:  # odd n, final real-ish pole: complex multiply
            a = zr * acc_re - zj * acc_im
            acc_im = zr * acc_im + zj * acc_re
            acc_re = a

    acc_re /= LREAL(1 << n)
    zero = LREAL(1) if is_highpass else LREAL(-1)
    return _zp2sos(n, zero, p, acc_re)


def design_sos(mode: int, degree: int, fc: float, fs: float, epsilon: float,
               dtype=np.float32) -> np.ndarray:
    """Design an SOS cascade; returns array [num_sections, 6] in ``dtype``.

    Mirrors processFilterOption (src/matrix.c:25-80): ``fc``/``fs`` enter only
    through w = π·fc/fs; ``epsilon`` is the (already /10) Chebyshev ripple
    exponent; the Chebyshev half-power scale is
    wh = cosh(acosh(1/sqrt(10^ε − 1))/degree).
    """
    if degree < 1:
        raise ValueError(f"filter degree must be >= 1, got {degree}")
    w = LREAL(np.pi) * LREAL(fc) / LREAL(fs)
    if mode in (CHEBY1_LP, CHEBY1_HP):
        eps = LREAL(epsilon)
        wh = np.cosh(LREAL(1) / LREAL(degree)
                     * np.arccosh(LREAL(1) / np.sqrt(LREAL(10) ** eps - 1)))
        tng = np.tan(w * wh)
        if mode == CHEBY1_HP:
            tng = LREAL(1) / tng
        sos = _transform_bilinear(degree, tng, eps, mode == CHEBY1_HP,
                                  _warp_cheby1, is_cheby_lp=(mode == CHEBY1_LP),
                                  reflect_gain=False)
    elif mode in (BUTTER_LP, BUTTER_HP):
        alpha = LREAL(1) / np.sin(LREAL(2) * w)
        beta = np.tan(w)
        sos = _transform_bilinear(degree, alpha, beta, mode == BUTTER_HP,
                                  _warp_butter, is_cheby_lp=False,
                                  reflect_gain=(mode == BUTTER_HP))
    else:
        raise ValueError(f"unknown filter mode {mode}")
    return sos.astype(dtype)
