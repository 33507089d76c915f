"""Critically-sampled polyphase analysis filterbank (PFB channelizer).

Splits one wideband complex stream at fs into C baseband channels on the
uniform grid f_k = k·fs/C, each at rate fs/C — the textbook efficient
channelizer: instead of C independent mix+decimate chains (C·T·K MACs per
block), the polyphase
decomposition runs ONE prototype filter at the low rate (T·P multiply-adds,
P taps per phase) followed by a C-point DFT across branches.

Design choices:
  * everything is REAL arithmetic on separate I/Q lanes, and for C ≤ ~256
    the C-point DFT is a dense [C, C] cos/sin matmul (the branch filter is
    the same framed static-slice trick as ops.resample);
  * no sequential state beyond a P·C−1-sample input history.

Math (validated in tests against a naive per-channel mix+decimate using
the same prototype): with frames F[m, c] = x[mC − c] (note the reversed
commutator) and prototype h of length P·C,

    z[m, c] = Σ_p h[pC + c] · F[m−p, c]
    y[m, k] = Σ_c z[m, c] · e^{+j2πkc/C}
            = Σ_j h[j] · x[mC − j] · e^{j2πkj/C}
            = decimate_C( (x·e^{−j2πk n/C}) * h )[m]

Because every center frequency is a multiple of fs/C, the decimated mixer
phase e^{−j2πk·mC/C} is identically 1 — channels are phase-coherent across
blocks with no carry phasor.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .resample import kaiser_lowpass

__all__ = ["PolyphaseChannelizer", "design_pfb_prototype"]

# Dot precision of the DFT and folded branch-filter einsums, measured on an
# H100 (C = 64, 0.25 s block, planes vs the CPU at HIGHEST): TF32
# (DEFAULT/HIGH) 74 dB, 3-pass bf16 113 dB, F32 exact at 1.1× the bank
# step; 3-pass bf16 clears the banks' 80 dB audio bar (PERF.md).
DOT_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def design_pfb_prototype(C: int, taps_per_phase: int = 12,
                         cutoff_frac: float = 0.45,
                         beta: float = 9.0) -> np.ndarray:
    """Prototype lowpass for a C-channel critically-sampled PFB: length
    P·C, cutoff cutoff_frac·(fs/C), unit DC gain, host float64."""
    K = taps_per_phase * C
    h = kaiser_lowpass(K, cutoff_frac / C, 1.0, beta=beta)
    if len(h) != K:  # kaiser_lowpass pads to odd length
        h = h[:K] if len(h) > K else np.pad(h, (0, K - len(h)))
    return h / h.sum()


class PolyphaseChannelizer:
    """iq: real [..., 2, T] (I/Q lanes, T % C == 0) →
    y: real [..., C, 2, T/C] per-channel I/Q.

    Channel k is centered at +k·fs/C (k interpreted mod C, so negative
    offsets live in the upper half).  State: the trailing P·C−1 input
    samples per lane (init zeros — stream assumed silent before t=0).
    """

    def __init__(self, C: int, taps_per_phase: int = 12,
                 dtype=jnp.float32, prototype: np.ndarray | None = None):
        self.C = C
        # the preset is a float32 algorithm; float64 dots stay exact
        self.precision = (DOT_PRECISION if jnp.dtype(dtype) == jnp.float32
                          else jax.lax.Precision.HIGHEST)
        h = (np.asarray(prototype, np.float64) if prototype is not None
             else design_pfb_prototype(C, taps_per_phase))
        assert h.size % C == 0, "prototype length must be P*C"
        self.P = h.size // C
        # taps for branch c multiply F[m−p, c] = x[(m−p)C − c]
        self._h_np = h.reshape(self.P, C)          # host copy: _split_mats
        # host numpy constant: a jnp constant would transfer device→host
        # again at every jit LOWERING (see ops/fir_apply.py JRealFir)
        self.hmat = self._h_np.astype(np.dtype(jnp.dtype(dtype).name))
        self.hist_len = self.P * C  # covers x[mC − j] down to j = PC−1
        self.dtype = dtype
        self._split_cache = None     # built lazily by call_split()
        # C-point DFT as dense real matmuls: W[k, c] = e^{+j2πkc/C}
        k = np.arange(C)[:, None] * np.arange(C)[None, :]
        theta = 2.0 * np.pi * (k % C) / C
        self._cos_np, self._sin_np = np.cos(theta), np.sin(theta)
        ndt = np.dtype(jnp.dtype(dtype).name)
        self.dft_cos = self._cos_np.astype(ndt)          # [K=C, c=C]
        self.dft_sin = self._sin_np.astype(ndt)

    def init_hist(self, batch_shape=()) -> jax.Array:
        return jnp.zeros((*batch_shape, 2, self.hist_len), self.dtype)

    def __call__(self, iq: jax.Array, hist: jax.Array):
        C, P = self.C, self.P
        T = iq.shape[-1]
        assert iq.shape[-2] == 2 and T % C == 0, iq.shape
        M = T // C
        lead = iq.shape[:-2]
        xc = jnp.concatenate(
            [jnp.broadcast_to(hist, (*lead, 2, self.hist_len)), iq], axis=-1)
        # F[m, c] = x_global[mC − c]; local index in xc is H + mC − c.
        # For shift p:  A_p[m, i] = xc[H − pC − (C−1) + mC + i], c = C−1−i.
        z = None
        for p in range(P):
            start = self.hist_len - p * C - (C - 1)
            frames = jax.lax.slice_in_dim(
                xc, start, start + M * C, axis=-1).reshape(*lead, 2, M, C)
            frames = jnp.flip(frames, axis=-1)  # i → c = C−1−i
            term = frames * self.hmat[p]
            z = term if z is None else z + term
        zr, zi = z[..., 0, :, :], z[..., 1, :, :]          # [..., M, C]
        # y[m, k] = Σ_c z[m, c]·(cos + j·sin)(2πkc/C) — two matmuls/lane
        def dft(z, w):
            return jnp.einsum("...mc,kc->...km", z, w,
                              precision=self.precision)
        yr = dft(zr, self.dft_cos) - dft(zi, self.dft_sin)
        yi = dft(zr, self.dft_sin) + dft(zi, self.dft_cos)
        y = jnp.stack([yr, yi], axis=-2)                   # [..., C, 2, M]
        new_hist = xc[..., xc.shape[-1] - self.hist_len:]
        return y, new_hist

    def _split_mats(self):
        """Host matrices for call_split: B2[q] [2C, 4C] folding prototype
        taps × DFT × commutator flip × even/odd output parity into the
        einsum operand (np arrays — trace-safe to cache on self).  Column
        blocks: [0:C) even·cos, [C:2C) even·sin, [2C:3C) odd·cos,
        [3C:4C) odd·sin."""
        if self._split_cache is None:
            C, P = self.C, self.P
            # host copies (NOT np.asarray of device arrays: that is a
            # device→host transfer at trace time)
            h = self._h_np                             # [P, C]
            Wc = self._cos_np                          # [K=C, C]
            Ws = self._sin_np
            jj = np.arange(P * C)
            Bc = h[jj // C, jj % C][:, None] * Wc[:, jj % C].T   # [PC, C]
            Bs = h[jj // C, jj % C][:, None] * Ws[:, jj % C].T
            W2 = 2 * C
            # Frame count must cover the EVEN-parity tap reach j = 2qC − i
            # (max 2(Q−1)C), which is the binding constraint: 2(Q−1)C ≥
            # PC−1.  For odd P that is one frame more than the odd-parity
            # reach alone, and the extra frame can start before the
            # history, so call_split left-pads xc with `pad2` zeros; the
            # padded reads only ever pair with out-of-range taps (j ≥ PC
            # ⇒ zero rows in B2), so they contribute nothing.
            Q = (P * C - 1 + W2 - 1) // W2 + 1
            pad2 = max(0, (Q - 1) * W2 - self.hist_len)
            dt = np.dtype(self.dtype)
            B2 = np.zeros((Q, W2, 4 * C))
            for q in range(Q):
                for i in range(W2):
                    for s in (0, 1):
                        j = 2 * q * C + s * C - i
                        if 0 <= j < P * C:
                            B2[q, i, 2*s*C:(2*s+1)*C] += Bc[j]
                            B2[q, i, (2*s+1)*C:(2*s+2)*C] += Bs[j]
            base2 = self.hist_len + pad2 - (Q - 1) * W2
            assert base2 >= 0, (self.hist_len, Q, W2, pad2)
            self._split_cache = (Q, W2, base2, pad2,
                                 [b.astype(dt) for b in B2])
        return self._split_cache

    def call_split(self, iq: jax.Array, hist: jax.Array):
        """Fast entry: y pre-split into even/odd time samples, REAL planes.

        iq [..., 2, T] (T % 2C == 0) → (yer, yei, yor, yoi
        [..., T/(2C), C], new_hist), where yer[..., m2, k] =
        Re y[k, 2·m2] etc.  One einsum family over 2C-wide frames with the
        taps × DFT × parity-split folded into HOST matrices: no per-phase
        misaligned slices or flips, and the pairs arrive planar for the
        discriminator (fm_demod_split)."""
        C = self.C
        Q, W2, base2, pad2, mats = self._split_mats()
        T = iq.shape[-1]
        assert iq.shape[-2] == 2 and T % W2 == 0, iq.shape
        M2 = T // W2
        lead = iq.shape[:-2]
        parts = [jnp.broadcast_to(hist, (*lead, 2, self.hist_len)), iq]
        if pad2:  # odd-P frame reach before the history (see _split_mats)
            parts.insert(0, jnp.zeros((*lead, 2, pad2), iq.dtype))
        xc = jnp.concatenate(parts, axis=-1)
        F2tot = (Q - 1) + M2
        xf = jax.lax.slice_in_dim(xc, base2, base2 + F2tot * W2, axis=-1)
        xf = xf.reshape(*lead, 2, F2tot, W2)
        acc = None
        for q in range(Q):
            z = jnp.einsum("...lfi,ik->...lfk", xf, mats[q],
                           precision=self.precision,
                           preferred_element_type=self.dtype)
            zq = jax.lax.slice_in_dim(z, (Q - 1) - q, (Q - 1) - q + M2,
                                      axis=-2)
            acc = zq if acc is None else acc + zq
        zI = acc[..., 0, :, :]                       # [..., M2, 4C]
        zQ = acc[..., 1, :, :]
        yer = zI[..., 0:C] - zQ[..., C:2*C]
        yei = zI[..., C:2*C] + zQ[..., 0:C]
        yor = zI[..., 2*C:3*C] - zQ[..., 3*C:4*C]
        yoi = zI[..., 3*C:4*C] + zQ[..., 2*C:3*C]
        new_hist = xc[..., xc.shape[-1] - self.hist_len:]
        return yer, yei, yor, yoi, new_hist

    def _split_vpu_consts(self):
        """Host constants for call_split_vpu (2C == 128 only): per-lane
        branch taps h2[P, 128] and the block DFT+parity matrix W4
        [128, 4C] (same output column blocks as call_split)."""
        if getattr(self, "_vpu_cache", None) is None:
            C, P = self.C, self.P
            assert 2 * C == 128, "call_split_vpu requires 2C == 128 lanes"
            h = self._h_np                      # [P, C]
            dt = np.dtype(self.dtype)
            L = np.arange(128)
            cc = C - 1 - (L % C)                # lane → branch c (flip
            h2 = h[:, cc]                       # folded into host taps)
            k = np.arange(C)
            theta = 2.0 * np.pi * (k[None, :] * cc[:, None] % C) / C
            W4 = np.zeros((128, 4 * C))
            even, odd = L < C, L >= C
            W4[even, 0:C] = np.cos(theta[even])
            W4[even, C:2 * C] = np.sin(theta[even])
            W4[odd, 2 * C:3 * C] = np.cos(theta[odd])
            W4[odd, 3 * C:4 * C] = np.sin(theta[odd])
            # flat alignment: pad xc' so window offsets hit lane residue 0
            # for even p and 64 for odd p (see call_split_vpu)
            lpad = (C - 1 - self.hist_len) % 128
            total_mod = (lpad + self.hist_len) % 128
            self._vpu_cache = (h2.astype(dt), W4.astype(dt), lpad,
                               (128 - total_mod) % 128)
        return self._vpu_cache

    def call_split_vpu(self, iq: jax.Array, hist: jax.Array):
        """call_split-compatible two-stage entry for 2C == 128 (C = 64).

        Not on the production path: the folded-operand call_split pays
        Q·4C dense MACs per input sample (~14× the algorithmic P + 2C cost
        at C = 64), and this entry restores the two-stage structure as a
        candidate to time against it.  Layout design:

          * elementwise branch filter: z'[m2·128 + L] =
            Σ_p h2[p, L]·xc'[m2·128 + L + H' − 64p] — with the history
            left-padded so H' ≡ C−1 (mod 128), every even-p window is a
            frame-ROW slice (free) and odd-p windows come from one
            half-lane-rotated copy (a single materialized concat);
          * one [128, 4C] einsum (Precision.HIGH) applying the C-point
            DFT to both frame parities at once — the commutator flip
            lives in the HOST matrices (h2, W4), never on device.

        Same returns as call_split: (yer, yei, yor, yoi [..., M2, C],
        new_hist).  Validated against call_split/__call__ in
        tests/test_channelizer.py.
        """
        C = self.C
        h2, W4, lpad, rpad = self._split_vpu_consts()
        T = iq.shape[-1]
        assert iq.shape[-2] == 2 and T % 128 == 0, iq.shape
        M2 = T // 128
        lead = iq.shape[:-2]
        P = self.P
        parts = [jnp.broadcast_to(hist, (*lead, 2, self.hist_len)), iq]
        if lpad:
            parts.insert(0, jnp.zeros((*lead, 2, lpad), iq.dtype))
        if rpad:
            parts.append(jnp.zeros((*lead, 2, rpad), iq.dtype))
        xc = jnp.concatenate(parts, axis=-1)
        G = xc.shape[-1] // 128
        xf = xc.reshape(*lead, 2, G, 128)          # aligned frame rows
        # half-lane-rotated copy for odd p: xo[f, l] = xc[f·128 + 64 + l]
        xo = jnp.concatenate([xf[..., :-1, 64:], xf[..., 1:, :64]], axis=-1)
        Hp = lpad + self.hist_len                  # ≡ C−1 (mod 128)
        zp = None
        for p in range(P):
            off = Hp - (C - 1) - p * C - (0 if p % 2 == 0 else 64)
            assert off % 128 == 0, (p, off)
            f0 = off // 128
            src = xf if p % 2 == 0 else xo
            win = jax.lax.slice_in_dim(src, f0, f0 + M2, axis=-2)
            term = win * h2[p]
            zp = term if zp is None else zp + term
        y4 = jnp.einsum("...lfi,ik->...lfk", zp, W4,
                        precision=self.precision,
                        preferred_element_type=self.dtype)
        zI, zQ = y4[..., 0, :, :], y4[..., 1, :, :]  # [..., M2, 4C]
        yer = zI[..., 0:C] - zQ[..., C:2*C]
        yei = zI[..., C:2*C] + zQ[..., 0:C]
        yor = zI[..., 2*C:3*C] - zQ[..., 3*C:4*C]
        yoi = zI[..., 3*C:4*C] + zQ[..., 2*C:3*C]
        # new_hist: trailing hist_len input samples (pads excluded)
        nh = jax.lax.slice_in_dim(xc, lpad + T,
                                  lpad + self.hist_len + T, axis=-1)
        return yer, yei, yor, yoi, nh

    def channel_index(self, offset_hz: float, fs: float) -> int:
        """Grid index for a center-frequency offset (must be on the grid)."""
        k = offset_hz * self.C / fs
        ki = int(round(k))
        if abs(k - ki) > 1e-6:
            raise ValueError(f"offset {offset_hz} not on the fs/C grid")
        return ki % self.C
