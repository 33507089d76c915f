"""Input-conditioning kernels (jnp).

Vectorized equivalents of the reference's conditioning family
(src/matrix.c:82-157).  All operate on the trailing axis and broadcast over
leading batch dims.  The reference fills outputs from both ends at once; for
the stateless kernels that ordering is irrelevant, while correctIq's
two-ended order defines the exact sequence its DC tracker sees and is
reproduced via an associative scan (log-depth, no lax.scan over samples).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["shift_origin", "normalize_input", "correct_iq", "split_iq",
           "split_iq_u16"]


def split_iq(raw: jax.Array, dtype=jnp.float32, kind: str = "shift"):
    """Deinterleave + condition uint8 IQ: [..., 2T] → (I [..., T], Q [..., T]).

    A bitcast to uint16 plus byte shifts is elementwise, where strided
    slices (``raw[0::2]``) may lower to gathers.  Little-endian byte order
    puts the first (I) byte in the low half (pinned against the C binary by
    the golden tests).

    Callers that can view the bytes as uint16 host-side (numpy ``.view`` is
    zero-copy) should use :func:`split_iq_u16` directly, so the device never
    repacks bytes.
    """
    *lead, n2 = raw.shape
    u16 = jax.lax.bitcast_convert_type(
        raw.reshape(*lead, n2 // 2, 2), jnp.uint16)
    return split_iq_u16(u16, dtype, kind)


def split_iq_u16(u16: jax.Array, dtype=jnp.float32, kind: str = "shift"):
    """As :func:`split_iq`, from the uint16 view: one u16 per complex
    sample, little-endian low byte = I, high byte = Q."""
    bi = (u16 & jnp.uint16(0xFF)).astype(jnp.int32)
    bq = (u16 >> 8).astype(jnp.int32)
    if kind == "shift":
        xi = jnp.where(bi == 255, -128, bi - 127).astype(dtype)
        xq = jnp.where(bq == 255, -128, bq - 127).astype(dtype)
    elif kind == "normalize":
        denom = dtype(np.float32(2.0 / 255.0)) if dtype == jnp.float32 \
            else dtype(2.0 / 255.0)
        xi = bi.astype(dtype) * denom - dtype(1.0)
        xq = bq.astype(dtype) * denom - dtype(1.0)
    else:  # pragma: no cover
        raise ValueError(kind)
    return xi, xq


def shift_origin(buf: jax.Array, dtype=jnp.float32) -> jax.Array:
    """uint8 → centered: (int8)(b - 127), with 255 wrapping to -128
    (src/matrix.c:82-98)."""
    v = buf.astype(jnp.int32) - 127
    v = jnp.where(v == 128, -128, v)
    return v.astype(dtype)


def normalize_input(buf: jax.Array, dtype=jnp.float32) -> jax.Array:
    """uint8 → [-1, 1]: b * (2/255) - 1 (src/matrix.c:100-118)."""
    denom = dtype(np.float32(2.0 / 255.0)) if dtype == jnp.float32 \
        else dtype(2.0 / 255.0)
    return buf.astype(dtype) * denom - dtype(1.0)


def correct_iq(buf: jax.Array, off: jax.Array, esr, dtype=jnp.float32):
    """Running per-lane DC-offset tracker (src/matrix.c:120-140).

    The C loop is a first-order linear recurrence over k = 0..len/4-1:

        outF = bufF[k] - off ;  outB = bufB[k] - off        (front/mirror pair)
        off' = off + (outF + outB)*esr = (1 - 2*esr)*off + (bufF+bufB)*esr

    Reformulated as an associative scan over affine maps (a, b): x → a·x + b,
    exact in real arithmetic (float rounding differs from the sequential C
    path by ~1e-7 relative — the recurrence is contracting, so differences
    stay bounded).  State ``off`` ([..., 2]) carries across blocks like the
    C ``static`` (src/matrix.c:125).

    buf: uint8 [..., L].  Returns (out [..., L] dtype, new_off [..., 2]).
    """
    # the decay base must stay a python float (host constant for the
    # geometric matrices); take it before the jnp cast
    a_scalar = 1.0 - 2.0 * float(np.float32(esr) if dtype == jnp.float32
                                 else esr)
    esr = dtype(esr)
    L = buf.shape[-1]
    n = L >> 2
    fb = buf.astype(dtype)
    front = fb[..., : L // 2].reshape(*buf.shape[:-1], n, 2)     # [..., n, 2]
    back_flat = fb[..., L // 2:].reshape(*buf.shape[:-1], n, 2)
    back = jnp.flip(back_flat, axis=-2)                          # pair k = L-2k-2
    s = (front + back) * esr                                     # b_k per lane

    off_b, new_off = _geometric_prefix(s, a_scalar, off, dtype)

    out_front = (front - off_b).reshape(*buf.shape[:-1], L // 2)
    out_back = jnp.flip(back - off_b, axis=-2).reshape(*buf.shape[:-1], L // 2)
    return jnp.concatenate([out_front, out_back], axis=-1), new_off


def _geometric_prefix(s: jax.Array, a: float, off: jax.Array, dtype):
    """Exclusive prefix of the affine recurrence x_{k+1} = a·x_k + s_k.

    Returns (off_b [..., n, 2] — the state BEFORE step k — and the final
    state [..., 2]).  A flat associative_scan over n materializes log2(n)
    full-size intermediate passes (~17 HBM round-trips for 64 Ki steps);
    instead the scan is blocked into 128-step chunks: the within-chunk
    prefixes are ONE matmul with a lower-triangular geometric Toeplitz
    matrix (matmul work, contraction 128), and only the n/128 chunk summaries
    see an associative_scan.  Exact in real arithmetic; f32 rounding
    differs from the sequential order by ~1e-7 relative (the recurrence is
    contracting).
    """
    n = s.shape[-2]
    C = 128
    if n % C:
        # fallback: flat scan (small/odd blocks only)
        a_vec = jnp.full_like(s, dtype(a))

        def combine(l, r):
            return (l[0] * r[0], l[1] * r[0] + r[1])

        a_inc, b_inc = jax.lax.associative_scan(combine, (a_vec, s), axis=-2)
        ones = jnp.ones_like(a_inc[..., :1, :])
        zeros = jnp.zeros_like(ones)
        a_exc = jnp.concatenate([ones, a_inc[..., :-1, :]], axis=-2)
        b_exc = jnp.concatenate([zeros, b_inc[..., :-1, :]], axis=-2)
        off_b = a_exc * off[..., None, :] + b_exc
        return off_b, a_inc[..., -1, :] * off + b_inc[..., -1, :]
    import numpy as np
    m = n // C
    lead = s.shape[:-2]
    sc = s.reshape(*lead, m, C, 2)
    k = np.arange(C)
    # T[k, j] = a^(k-1-j) for j < k (exclusive within-chunk prefix)
    expo = k[:, None] - 1 - k[None, :]
    T = np.where(expo >= 0, np.power(float(a), np.maximum(expo, 0)), 0.0)
    Tj = jnp.asarray(T, dtype)
    w = jnp.asarray(np.power(float(a), C - 1 - k), dtype)       # summary row
    p_within = jnp.einsum("kj,...jl->...kl", Tj, sc,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=dtype)
    b_chunk = jnp.einsum("j,...jl->...l", w, sc,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=dtype)          # [..., m, 2]
    a_chunk = float(a) ** C
    off_chunk, (A, b) = correct_iq_block_prefix(dtype(a_chunk), b_chunk, off)
    apow = jnp.asarray(np.power(float(a), k), dtype)
    off_b = (apow[:, None] * off_chunk[..., :, None, :] + p_within)
    return off_b.reshape(*lead, n, 2), A * off + b


def correct_iq_zero(buf: jax.Array, esr, dtype=jnp.float32):
    """correct_iq evaluated at off = 0, plus the block's affine summary.

    Because the tracker recurrence is affine, a block's output for any
    initial offset decomposes as

        out(off0) = out(0) - decay^k · off0        (per pair-step k)
        off_end(off0) = a_tot · off0 + b_tot,  a_tot = (1-2·esr)^(L/4)

    which makes multi-block / multi-shard processing embarrassingly parallel:
    compute out(0) everywhere, then fix up with the (tiny) prefix of block
    summaries — see demodulator_tpu.parallel.sharding.

    Returns (out0 [..., L], b_tot [..., 2]).
    """
    zero = jnp.zeros((*buf.shape[:-1], 2), dtype=dtype)
    return correct_iq(buf, zero, esr, dtype)


def correct_iq_decay(L: int, esr, dtype=jnp.float32) -> jax.Array:
    """decay^k for k = 0..L/4-1 (host-computed constant, f64 accumulated)."""
    import numpy as np
    a = 1.0 - 2.0 * float(np.float32(esr) if dtype == jnp.float32 else esr)
    pows = np.power(a, np.arange(L >> 2, dtype=np.float64))
    return jnp.asarray(pows, dtype)


def correct_iq_block_prefix(a_tot: jax.Array, b_tot: jax.Array,
                            off0: jax.Array):
    """Exclusive affine prefix over a block axis (axis -2 of b_tot).

    a_tot: scalar decay per block ((1-2·esr)^(L/4)); b_tot: [..., NB, 2]
    per-block summaries from correct_iq_zero; off0: [..., 2] incoming
    state.  Returns (off_before [..., NB, 2] — the tracker state entering
    each block — and the (A_loc, b_loc) affine summary of the whole span,
    for chaining across shards/chunks).  log-depth, O(NB) work: this is
    what makes batched multi-block correctIq embarrassingly parallel
    instead of a lax.scan over blocks.
    """
    a_vec = jnp.full_like(b_tot, a_tot)

    def combine(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    a_inc, b_inc = jax.lax.associative_scan(combine, (a_vec, b_tot), axis=-2)
    ones = jnp.ones_like(a_inc[..., :1, :])
    zeros = jnp.zeros_like(ones)
    a_exc = jnp.concatenate([ones, a_inc[..., :-1, :]], axis=-2)
    b_exc = jnp.concatenate([zeros, b_inc[..., :-1, :]], axis=-2)
    off_before = a_exc * off0[..., None, :] + b_exc
    return off_before, (a_inc[..., -1, :], b_inc[..., -1, :])


def correct_iq_apply_offset(out0: jax.Array, off0: jax.Array,
                            decay_pows: jax.Array) -> jax.Array:
    """Fix up out(0) → out(off0): subtract decay^k·off0 at pair-step k's four
    positions (front pair 2k,2k+1 and mirror pair L-2k-2,L-2k-1)."""
    L = out0.shape[-1]
    n = L >> 2
    corr = decay_pows[..., :, None] * off0[..., None, :]      # [..., n, 2]
    front = corr.reshape(*corr.shape[:-2], L // 2)
    back = jnp.flip(corr, axis=-2).reshape(*corr.shape[:-2], L // 2)
    return out0 - jnp.concatenate([front, back], axis=-1)
