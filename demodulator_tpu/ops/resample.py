"""Polyphase rational resampler (banded matmuls).

The reference has no resampler (`-S` only normalizes filter cutoffs,
src/matrix.c:34; SURVEY.md §1 fact 2) — this is the framework extension
behind BASELINE config 5 (WBFM: 2.4 Msps → 48 kHz audio).

Design (host, float64): windowed-sinc lowpass under a Kaiser window.
Application (device): for L == 1 (decimation and plain FIR) a banded-
Toeplitz chunked matmul (see PolyResampler.__init__); for L > 1 the
L-fold upsample → FIR → M-fold decimate is a single
``lax.conv_general_dilated`` with ``lhs_dilation=(L,)`` and
``window_strides=(M,)``.

Streaming: blocks are glued with an input-side history of
``ceil((K-1)/L)`` samples (overlap-save).  Block length T must satisfy
``T·L % M == 0`` so every block yields the same static output length and the
polyphase phase realigns to zero at each block boundary — no dynamic phase
carry, which keeps shapes static under jit.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["kaiser_lowpass", "design_resampler_taps", "PolyResampler"]


def kaiser_lowpass(num_taps: int, cutoff: float, fs: float,
                   beta: float = 9.0) -> np.ndarray:
    """Linear-phase lowpass: sinc(2·fc/fs) × Kaiser(beta), unit DC gain.
    Host-side float64 design (like the reference's startup-time LREAL filter
    design, src/filter.c:142-210 — ours is FIR because the application is a
    stationary matmul, not a biquad recurrence)."""
    if num_taps % 2 == 0:
        num_taps += 1  # symmetric, integer group delay
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2
    fc = 2.0 * cutoff / fs
    h = fc * np.sinc(fc * n)
    w = np.i0(beta * np.sqrt(1.0 - (2.0 * n / (num_taps - 1)) ** 2))
    w /= np.i0(beta)
    h *= w
    return h / h.sum()


def design_resampler_taps(L: int, M: int, fs_in: float,
                          cutoff: float | None = None,
                          atten_db: float = 80.0,
                          transition: float | None = None) -> np.ndarray:
    """Anti-alias/anti-image taps at the intermediate rate L·fs_in.

    cutoff defaults to 90% of the tighter Nyquist (min(fs_in, fs_out)/2);
    tap count from the Kaiser estimate for ``atten_db`` over ``transition``
    (default: the band from cutoff to the tighter Nyquist).  DC gain L so
    upsampling preserves amplitude.
    """
    fs_hi = fs_in * L
    fs_out = fs_in * L / M
    nyq = min(fs_in, fs_out) / 2.0
    if cutoff is None:
        cutoff = 0.9 * nyq
    if transition is None:
        transition = max(nyq - cutoff, 0.02 * nyq)
    beta = (0.1102 * (atten_db - 8.7) if atten_db > 50 else
            0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21))
    num_taps = int(math.ceil((atten_db - 7.95)
                             / (2.285 * 2 * math.pi * transition / fs_hi)))
    h = kaiser_lowpass(num_taps, cutoff, fs_hi, beta=beta)
    return h * L


class PolyResampler:
    """Rational L/M resampler with streaming overlap-save history.

    taps: 1-D float64 array at the rate L·fs_in (pass custom taps to reuse
    this op as a plain streaming FIR with L = M = 1 — e.g. de-emphasis).
    """

    def __init__(self, L: int, M: int, taps: np.ndarray,
                 dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST):
        """precision: dot precision (a lax.Precision or a
        lax.DotAlgorithmPreset) of the banded matmuls and of the L > 1
        convolution; HIGHEST (exact f32) by default.

        ``precision="split2_bf16"`` (L == 1 banded path only): 2-pass
        operand-split dots for inputs EXACTLY representable in bf16 — the
        conditioned uint8 signal is integers in [-128, 127] (8 significand
        bits suffice), so casting the signal operand is lossless and only
        the taps split hi+lo; tap error ~2^-17 rel (~-100 dB stopband
        perturbation); two bf16 dots with f32 accumulation."""
        self.precision = precision
        self._split2 = precision == "split2_bf16"
        g = math.gcd(L, M)
        self.L, self.M = L // g, M // g
        if self._split2 and self.L != 1:
            # the upfirdn conv path has no operand-split form; HIGHEST is
            # the accuracy-equivalent fallback
            self.precision = jax.lax.Precision.HIGHEST
            self._split2 = False
        taps = np.asarray(taps, np.float64)
        K = taps.shape[0]
        self.dtype = dtype
        if self.L == 1:
            # Banded-Toeplitz chunked-matmul formulation (the common
            # decimate/FIR case).  The op is the correlation
            #     y[t] = Σ_j hp[j] · xc[H + t·M − j],   j ∈ [0, P·M)
            # with H = P·M−1 input history.  Tiling outputs into chunks of
            # 128 (one lane row each) makes every chunk one real matmul:
            #     y[c, :] = window[c, :] @ G,   window[c] = xc[c·128·M : +W]
            # with W = (P+127)·M and G the [W, 128] banded tap matrix —
            # large-contraction matmul work, in place of P shifted
            # slice+einsum(M) steps with a copy per shift.  FLOP overhead
            # of the band's zeros is (P+127)/128 ≈ 1–2×.
            P = -(-K // self.M)
            hp = np.zeros(P * self.M, np.float64)
            hp[:K] = taps
            self.P = P
            self.hist_len = P * self.M - 1
            self.chunk = 128
            stride = self.chunk * self.M
            W = (P + self.chunk - 1) * self.M
            s = -(-W // stride)
            # G[r, u] = hp[u·M + P·M − 1 − r]  (zero outside the band),
            # zero-padded to s·stride rows and pre-split into s [stride,
            # chunk] pieces — one per frame-row offset (see __call__)
            r = np.arange(s * stride)[:, None]
            u = np.arange(self.chunk)[None, :]
            j = u * self.M + P * self.M - 1 - r
            ok = (j >= 0) & (j < P * self.M)
            G = np.zeros((s * stride, self.chunk), np.float64)
            G[ok] = hp[j[ok]]
            # host numpy constants (see ops/fir_apply.py JRealFir)
            self.gmats = [self._cast_mat(G[k * stride:(k + 1) * stride])
                          for k in range(s)]
            self._hp = hp                # f64 padded taps, for framed()
            self._framed_mats = None     # built lazily by framed()
            self._framed_mats2 = None    # built lazily by framed2()
            self.kernel = None
            return
        # General rational case: upfirdn as a dilated/strided conv.
        # history so every tap of the first output lands on real data
        self.hist_len = max(1, -(-(K - 1) // self.L))
        Kg = self.hist_len * self.L + 1
        # correlation kernel: g[q] = h[hist_len·L − q], zero-padded
        gk = np.zeros(Kg, np.float64)
        src = np.arange(Kg)
        idx = self.hist_len * self.L - src
        ok = (idx >= 0) & (idx < K)
        gk[src[ok]] = taps[idx[ok]]
        self.kernel = gk[None, None, :].astype(
            np.dtype(jnp.dtype(dtype).name))
        # group delay of the symmetric taps, in output samples: the op
        # computes the exact global upfirdn y[m] = Σ_j h[mM − jL]·x[j]
        self.delay_out = (K - 1) / 2.0 / self.M

    def _cast_mat(self, g64: np.ndarray):
        """Host tap matrix in its dot-ready form: dtype array, or an
        (hi, lo) bf16 pair for the split2_bf16 mode."""
        if self._split2:
            import ml_dtypes
            hi = g64.astype(ml_dtypes.bfloat16)
            lo = (g64 - hi.astype(np.float64)).astype(ml_dtypes.bfloat16)
            return (hi, lo)
        return g64.astype(np.dtype(jnp.dtype(self.dtype).name))

    def _dot(self, x, g):
        """One banded-matmul piece: x [..., r, w] @ g [w, u]."""
        if self._split2:
            xb = x.astype(jnp.bfloat16)  # lossless: integer signal
            hi = jnp.einsum("...rw,wu->...ru", xb, g[0],
                            preferred_element_type=self.dtype)
            lo = jnp.einsum("...rw,wu->...ru", xb, g[1],
                            preferred_element_type=self.dtype)
            return hi + lo
        return jnp.einsum("...rw,wu->...ru", x, g,
                          precision=self.precision,
                          preferred_element_type=self.dtype)

    def out_len(self, T: int) -> int:
        assert (T * self.L) % self.M == 0, \
            f"block length {T} must satisfy T·{self.L} % {self.M} == 0"
        return T * self.L // self.M

    def init_hist(self, batch_shape=()) -> jax.Array:
        return jnp.zeros((*batch_shape, self.hist_len), self.dtype)

    def _framed_geometry(self):
        """(stride, s', hr, G'_k list) for the framed entry (L == 1 only).

        Derivation: with xcp' = zeros(hr·stride − H) ++ hist ++ x the op is
        y[t] = Σ_j hp[j]·xcp'[hr·stride + t·M − j]; splitting xcp' into
        stride-rows i and writing k = hr + c − i gives
            y[c·chunk + u] = Σ_k (xr' @ G'_k)[hr − k + c, u],
            G'_k[w, u] = hp[k·stride + u·M − w]   (zero outside [0, P·M)).
        hr = max(⌈H/stride⌉, s'−1) zero-padded history rows keep every row
        slice in range (the extra all-zero rows contribute nothing).
        """
        if self._framed_mats is None:
            M, chunk, P = self.M, self.chunk, self.P
            stride = chunk * M
            s = (P * M - 1 + (chunk - 1) * M) // stride + 1
            hr = max(-(-self.hist_len // stride), s - 1)
            hp = self._hp
            mats64 = []
            for k in range(s):
                w = np.arange(stride)[:, None]
                u = np.arange(chunk)[None, :]
                j = k * stride + u * M - w
                ok = (j >= 0) & (j < P * M)
                G = np.zeros((stride, chunk), np.float64)
                G[ok] = hp[j[ok]]
                mats64.append(G)
            # cache HOST constants: jnp.asarray inside a jit trace
            # yields a tracer, and caching a tracer on self poisons
            # every later trace (UnexpectedTracerError on the second
            # jit that reaches framed())
            self._framed_mats = (stride, s, hr,
                                 [self._cast_mat(G) for G in mats64],
                                 mats64)
        return self._framed_mats

    def framed(self, x_frames: jax.Array, hist: jax.Array):
        """Layout-friendly L==1 entry: x pre-framed as [..., R, stride]
        (a host/natural reshape of [..., R·stride]; stride = chunk·M), so
        no device-side flat→framed relayout of the full-rate signal is ever
        paid.

        Returns (y [..., C, chunk] with C = R·stride/(chunk·M) = R, and
        new_hist [..., hist_len]).  Numerically identical to __call__ on
        the flattened input.
        """
        assert self.kernel is None and self.L == 1
        stride, s, hr, mats, _ = self._framed_geometry()
        *lead, R, st = x_frames.shape
        assert st == stride, (st, stride)
        H = self.hist_len
        hist_rows = jnp.pad(
            hist, [*[(0, 0)] * (hist.ndim - 1), (hr * stride - H, 0)]
        ).reshape(*lead, hr, stride).astype(x_frames.dtype)
        xr = jnp.concatenate([hist_rows, x_frames], axis=-2)  # [.., hr+R, st]
        y = None
        for k, gk in enumerate(mats):
            z = self._dot(xr, gk)
            zk = jax.lax.slice_in_dim(z, hr - k, hr - k + R, axis=-2)
            y = zk if y is None else y + zk
        # new history: last H samples of x (tiny flat slice; back to the
        # carry dtype — exact for bf16 integer frames)
        tail_rows = -(-H // stride)
        tail = x_frames[..., R - tail_rows:, :].reshape(*lead, -1)
        return y, tail[..., -H:].astype(self.dtype)

    def framed2(self, x_frames: jax.Array, hist: jax.Array):
        """As :meth:`framed`, but the output arrives pre-split into its
        even and odd samples: (y_even [..., R, chunk/2], y_odd [..., R,
        chunk/2], new_hist).  y_even[..., r, u] = y[..., r, 2u].

        The split is free: the selection happens in the HOST tap matrices
        (every other column of each G'_k), so the two half-width matmuls
        cost exactly one full-width one.  This exists for the quadrature
        discriminator, whose conj-product pairs consecutive decimator
        outputs: the column split replaces a stride-2 deinterleave of the
        flat stream on device."""
        assert self.kernel is None and self.L == 1
        assert self.chunk % 2 == 0
        stride, s, hr, mats, mats64 = self._framed_geometry()
        if self._framed_mats2 is None:
            # host-side column split (np arrays: trace-safe to cache)
            self._framed_mats2 = (
                [self._cast_mat(m[:, 0::2].copy()) for m in mats64],
                [self._cast_mat(m[:, 1::2].copy()) for m in mats64])
        mats_e, mats_o = self._framed_mats2
        *lead, R, st = x_frames.shape
        assert st == stride, (st, stride)
        H = self.hist_len
        hist_rows = jnp.pad(
            hist, [*[(0, 0)] * (hist.ndim - 1), (hr * stride - H, 0)]
        ).reshape(*lead, hr, stride).astype(x_frames.dtype)
        xr = jnp.concatenate([hist_rows, x_frames], axis=-2)
        ye = yo = None
        for k in range(s):
            ze = self._dot(xr, mats_e[k])
            zo = self._dot(xr, mats_o[k])
            zke = jax.lax.slice_in_dim(ze, hr - k, hr - k + R, axis=-2)
            zko = jax.lax.slice_in_dim(zo, hr - k, hr - k + R, axis=-2)
            ye = zke if ye is None else ye + zke
            yo = zko if yo is None else yo + zko
        tail_rows = -(-H // stride)
        tail = x_frames[..., R - tail_rows:, :].reshape(*lead, -1)
        return ye, yo, tail[..., -H:].astype(self.dtype)

    def __call__(self, x: jax.Array, hist: jax.Array):
        """x: [..., T] → (y [..., T·L/M], new_hist [..., hist_len])."""
        T = x.shape[-1]
        Tout = self.out_len(T)
        lead = x.shape[:-1]
        xc = jnp.concatenate(
            [jnp.broadcast_to(hist, (*lead, self.hist_len)), x], axis=-1)
        if self.kernel is None:
            # banded chunked matmul (derivation in __init__):
            #   y[c·chunk + u] = Σ_k (xr @ G_k)[c + k, u]
            # with xr the padded input reshaped into non-overlapping
            # [C+s, chunk·M] frame rows.  Matmul-ing the FULL frame tensor
            # with each per-offset tap piece and adding row-shifted
            # OUTPUTS (tiny [C+s, 128] tensors) avoids building overlapping
            # windows of the big input — the concat-of-slices alternative
            # pays several relayout copies of the whole signal; this form
            # pays exactly one (the reshape) plus s dots.
            M, chunk, s = self.M, self.chunk, len(self.gmats)
            stride = chunk * M
            C = -(-Tout // chunk)
            need = (C + s) * stride
            xcp = jnp.pad(xc, [*[(0, 0)] * len(lead),
                               (0, need - xc.shape[-1])])
            xr = xcp.reshape(*lead, C + s, stride)
            y = None
            for k, gk in enumerate(self.gmats):
                z = self._dot(xr, gk)
                zk = jax.lax.slice_in_dim(z, k, k + C, axis=-2)
                y = zk if y is None else y + zk
            y = y.reshape(*lead, C * chunk)[..., :Tout]
            new_hist = xc[..., xc.shape[-1] - self.hist_len:]
            return y.astype(self.dtype), new_hist
        lhs = xc.reshape(-1, 1, xc.shape[-1]).astype(self.dtype)
        hi = max(0, self.L - self.M)
        out = jax.lax.conv_general_dilated(
            lhs, self.kernel,
            window_strides=(self.M,),
            padding=[(0, hi)],
            lhs_dilation=(self.L,),
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=self.precision,
            preferred_element_type=self.dtype,
        )
        y = out.reshape(*lead, -1)[..., :Tout]
        new_hist = xc[..., xc.shape[-1] - self.hist_len:]
        return y, new_hist
