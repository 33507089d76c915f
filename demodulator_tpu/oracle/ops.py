"""Sequential numpy golden model of the reference DSP chain.

Every function here replicates, operation-for-operation and in the same
floating-point order, the corresponding C routine in the reference
(src/matrix.c, src/filter.c).  It is intentionally *slow* (Python loops for
the sequential recurrences) and exists for three purposes:

  1. test oracle — byte/SNR comparison target for the JAX pipeline,
     cross-validated against the compiled C binary;
  2. FIR tap extraction — demodulator_tpu.ops.fir probes these routines with
     impulses to derive the exact equivalent linear operator of the
     reference's nonstandard SOS recurrence;
  3. documentation of quirks — each quirk the reference exhibits is written
     out explicitly and commented.

dtype: float32 to mirror the default build; float64 mirrors -DSET_PRECISION.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "shift_origin",
    "normalize_input",
    "correct_iq",
    "fm_demod",
    "apply_filter",
    "apply_complex_filter",
    "apply_filter_ip",
    "apply_complex_filter_ip",
]


def shift_origin(buf: np.ndarray, dtype=np.float32) -> np.ndarray:
    """uint8 → centered REAL via (int8)(b - 127) (src/matrix.c:82-98).

    255 wraps to -128 through the int8 cast.  The reference fills from both
    ends simultaneously but covers each index exactly once, so order is
    irrelevant here.
    """
    v = buf.astype(np.int32) - 127
    v = np.where(v == 128, -128, v)
    return v.astype(dtype)


def normalize_input(buf: np.ndarray, dtype=np.float32) -> np.ndarray:
    """uint8 → [-1, 1]: b * (2/255) - 1 (src/matrix.c:100-118)."""
    denom = dtype(2.0 / 255.0)
    return (buf.astype(dtype) * denom - dtype(1.0)).astype(dtype)


def correct_iq(buf: np.ndarray, off: np.ndarray, esr, dtype=np.float32):
    """Running DC-offset tracker, stateful across blocks (src/matrix.c:120-140).

    Processes pairs two-ended: iteration k handles front pair (2k, 2k+1) and
    mirror pair (len-2k-2, len-2k-1), subtracting the *current* offset from
    all four samples, then updates off[lane] += (front + mirror) * esr.
    Input values are RAW uint8 magnitudes (no origin shift).
    Returns (out, new_off).
    """
    esr = dtype(esr)
    ln = len(buf)
    out = np.zeros(ln, dtype=dtype)
    off = np.array(off, dtype=dtype).copy()
    n_steps = ln >> 2  # i ranges over even values < len/2
    for k in range(n_steps):
        i = 2 * k
        out[i] = dtype(buf[i]) - off[0]
        out[ln - i - 2] = dtype(buf[ln - i - 2]) - off[0]
        out[i + 1] = dtype(buf[i + 1]) - off[1]
        out[ln - i - 1] = dtype(buf[ln - i - 1]) - off[1]
        off[0] += (out[i] + out[ln - i - 2]) * esr
        off[1] += (out[i + 1] + out[ln - i - 1]) * esr
    return out, off


def fm_demod(x: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Quadrature discriminator (src/matrix.c:159-176).

    Per non-overlapping pair of complex samples (a+bi, c+di):
    zr = a*c + b*d, zj = -a*d + b*c  (= z1 * conj(z2) ... with the sign
    convention as written), out = atan2(zj, zr) with NaN → 0.
    Decimates 4 reals → 1 real.
    """
    x = x.astype(dtype, copy=False)
    a, b, c, d = x[0::4], x[1::4], x[2::4], x[3::4]
    zr = a * c + b * d
    zj = -a * d + b * c
    out = np.arctan2(zj, zr).astype(dtype)
    return np.where(np.isnan(out), dtype(0), out)


def apply_filter_ip(x: np.ndarray, y: np.ndarray, length: int, sos: np.ndarray) -> None:
    """In-place exact model of applyFilter (src/filter.c:212-231).

    ``x`` must expose at least length + sosLen + 1 readable entries and ``y``
    at least length + 2*sosLen writable entries; both are numpy views, so
    callers can alias them into one arena exactly like the C consumer's
    ``filterRet`` layout.  y is NOT zeroed here (the consumer zeroes the
    arena each block; stale/corrupted head values are part of the semantics).
    """
    dtype = sos.dtype.type
    sos_len = len(sos)
    one = dtype(1)
    coef = [tuple(dtype(c) for c in row) for row in np.asarray(sos)]
    for i in range(length):
        j = i + sos_len
        for m in range(sos_len):
            b0, b1, _, a0, a1, a2 = coef[m]
            y[j + m] = (b0 * y[j + m] + b1 * y[j + m + 1] + one) \
                - (a0 + a1 * x[j + m] + a2 * x[j + m + 1])


def apply_complex_filter_ip(x: np.ndarray, y: np.ndarray, length: int,
                            sos: np.ndarray) -> None:
    """In-place exact model of applyComplexFilter (src/filter.c:233-259).

    Reads x up to index length + 4*sosLen - 1 and writes y up to index
    length + 4*sosLen - 3 (the tail OVERRUN that scribbles into whatever
    region follows y in the consumer's arena — reproducing that coupling is
    why this operates on caller-provided views).  Q lane lacks the I lane's
    ``+ 1`` and therefore picks up a -1 affine constant per section.
    """
    dtype = sos.dtype.type
    sos_len = len(sos)
    one = dtype(1)
    coef = [tuple(dtype(c) for c in row) for row in np.asarray(sos)]
    for i in range(0, length, 2):
        j = i + (sos_len << 1)
        for m in range(sos_len):
            b0, b1, _, a0, a1, a2 = coef[m]
            l = j + (m << 1)
            y[l] = (b0 * y[l] + b1 * y[l + 2] + one) \
                - (a0 + a1 * x[l] + a2 * x[l + 2])
            y[l + 1] = (b0 * y[l + 1] + b1 * y[l + 3]) \
                - (a0 + a1 * x[l + 1] + a2 * x[l + 3])


def apply_filter(x: np.ndarray, length: int, sos: np.ndarray) -> np.ndarray:
    """The reference's nonstandard real SOS recurrence (src/filter.c:212-231).

    y starts at zero.  For i in 0..len-1, j = i + sosLen, for m in
    0..sosLen-1:

        y[j+m] = sos[m][0]*y[j+m] + sos[m][1]*y[j+m+1] + 1
                 - (sos[m][3] + sos[m][4]*x[j+m] + sos[m][5]*x[j+m+1])

    Quirks preserved: b2 = sos[m][2] is never read; b-coefficients multiply
    y and a-coefficients multiply x (roles swapped); reads of y[j+m+1] pick
    up partially-updated future values; x is read up to index
    len-1+2*sosLen (zero-padded here — the C buffers are calloc'd larger).
    The returned y has length `length` (positions < sosLen remain zero).
    """
    dtype = sos.dtype.type
    sos_len = len(sos)
    ext = length + 2 * sos_len + 1
    x_ext = np.zeros(ext, dtype=dtype)
    x_ext[: min(len(x), ext)] = x[:ext]
    y = np.zeros(ext, dtype=dtype)
    apply_filter_ip(x_ext, y, length, sos)
    return y[:length]


def apply_complex_filter(x: np.ndarray, length: int, sos: np.ndarray) -> np.ndarray:
    """Interleaved-I/Q variant of the recurrence (src/filter.c:233-259).

    Same sliding structure with stride 2 and j = i + 2*sosLen.  Quirk: the
    Q lane lacks the `+ 1` the I lane has, yet still subtracts
    sos[m][3] (= 1), leaving a -1 affine constant per section application on
    Q.  x is read up to index len-1+4*sosLen+1; consumed outputs only ever
    reach 2 reals past len, which alias the (always-zero) head of y in the
    C layout — modeled as zero padding.
    """
    dtype = sos.dtype.type
    sos_len = len(sos)
    ext = length + 4 * sos_len + 4
    x_ext = np.zeros(ext, dtype=dtype)
    x_ext[: min(len(x), ext)] = x[:ext]
    y = np.zeros(ext, dtype=dtype)
    apply_complex_filter_ip(x_ext, y, length, sos)
    return y[:length]
