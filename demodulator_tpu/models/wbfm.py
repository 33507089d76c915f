"""WBFM broadcast receiver (framework extension — BASELINE config 5).

The reference is NBFM-only (no resampler, SURVEY.md §1 fact 2); this model
is the textbook broadcast-FM chain built from the framework's ops:

    uint8 IQ @ fs (e.g. 2.4 Msps)
      → conditioning (shiftOrigin semantics, src/matrix.c:82-98)
      → polyphase channel-select decimation of complex baseband
        (fs → quad_rate, banded matmuls — ops/resample.py)
      → quadrature discriminator (conj-product + atan2, inherent 2:1,
        src/matrix.c:159-176 semantics via ops/demod.py)
      → polyphase resample to audio_rate with 15 kHz anti-alias cutoff
      → 1-pole de-emphasis (τ = 75 µs US / 50 µs EU), applied at audio
        rate as its exact exponential FIR projection (error < 1e-10)
      → deviation-normalized float32 audio in [-1, 1]

All stages are stationary convolutions or elementwise maps — no sequential
recurrence anywhere, so the whole chain jits to fused elementwise and
matmul work.  A
[C]-leading multi-station batch shards over the mesh's `chan` axis with
zero communication (WbfmPipeline.shard_over; CLI ``--wbfm --inputs
f1,..,fC [--shard-chan N]``).  State is the overlap-save histories
(continuous across blocks by construction).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_block_seconds
from ..ops import conditioning as cond_ops
from ..ops import demod as demod_ops
from ..ops.resample import PolyResampler, design_resampler_taps, kaiser_lowpass

__all__ = ["WbfmConfig", "WbfmState", "WbfmPipeline"]


def _rat(x: float, max_den: int = 1 << 20):
    from fractions import Fraction
    f = Fraction(x).limit_denominator(max_den)
    return f.numerator, f.denominator


@dataclasses.dataclass
class WbfmConfig:
    sample_rate: float = 2.4e6       # complex input rate
    audio_rate: float = 48000.0
    deviation: float = 75000.0       # broadcast FM peak deviation
    deemphasis_us: float = 75.0      # 75 µs US / 50 µs EU; 0 disables
    quad_rate: float = 0.0           # discriminator input rate; 0 ⇒ auto
    audio_cutoff: float = 15000.0
    atten_db: float = 80.0
    conditioning: str = "shift"      # "shift" | "normalize"
    # target block duration; 0 ⇒ the backend's default
    # (config.default_block_seconds)
    block_seconds: float = 0.0

    def resolved_block_seconds(self) -> float:
        return self.block_seconds or default_block_seconds("wbfm")

    def resolved_quad_rate(self) -> float:
        if self.quad_rate:
            return self.quad_rate
        # largest integer decimation keeping Carson bandwidth + margin;
        # strongly prefer decimation-only audio chains (L == 1): they run as
        # banded matmuls, while upsampling needs the lhs_dilation conv path
        # of ops/resample.py
        carson = 2.0 * (self.deviation + self.audio_cutoff)
        dmax = max(1, int(self.sample_rate
                          // max(carson * 1.6, 2 * self.audio_rate)))
        for want_l1 in (True, False):
            for d in range(dmax, 0, -1):
                q = self.sample_rate / d
                L, M = _rat(self.audio_rate / (q / 2.0))
                if L > 64 or M > 4096:
                    continue
                if want_l1 and L != 1:
                    continue
                return q
        return self.sample_rate


class WbfmState(NamedTuple):
    chan_hist: jax.Array    # [..., 2, Hc] I/Q channel-filter history
    audio_hist: jax.Array   # [..., Ha]    audio resampler history
    deemph_hist: jax.Array  # [..., Hd]    de-emphasis FIR history


class WbfmPipeline:
    """Jit-able per-block WBFM graph.  Blocks are continuous by design."""

    def __init__(self, cfg: WbfmConfig, dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        fs = cfg.sample_rate
        quad = cfg.resolved_quad_rate()

        # stage 1: complex channel-select decimator fs → quad
        L1, M1 = _rat(quad / fs)
        carson = 2.0 * (cfg.deviation + cfg.audio_cutoff)
        t1 = design_resampler_taps(
            L1, M1, fs, cutoff=min(0.5 * carson * 1.1, 0.45 * quad),
            atten_db=cfg.atten_db)
        # "shift" conditioning yields integers in [-128, 127] — exactly
        # representable in bf16 — so the decimator dots run the 2-pass
        # operand-split mode (bf16 signal exact, taps split hi+lo).
        # Measured on an H100 (audio vs the CPU at HIGHEST, 1 s blocks):
        # split2 141 dB, TF32 123 dB at the same step time, F32 144 dB at
        # 1.6× the step (PERF.md; CPU test bar 90 dB, tests/test_wbfm.py).
        chan_prec = ("split2_bf16"
                     if cfg.conditioning == "shift" and dtype == jnp.float32
                     else jax.lax.Precision.HIGHEST)
        self.chan = PolyResampler(L1, M1, t1, dtype, precision=chan_prec)

        # stage 2: discriminator quad → quad/2 (ops.demod, 2:1 inherent)
        demod_rate = quad / 2.0

        # stage 3: audio resampler quad/2 → audio_rate, 15 kHz cutoff
        L2, M2 = _rat(cfg.audio_rate / demod_rate)
        t2 = design_resampler_taps(
            L2, M2, demod_rate,
            cutoff=min(cfg.audio_cutoff, 0.45 * cfg.audio_rate),
            atten_db=cfg.atten_db)
        # audio resampler and de-emphasis dots: 3-pass bf16, measured on an
        # H100 (with the split2 decimator): 111 dB, vs F32 141 dB at 1.4×
        # the chain's step and TF32 81 dB (under the 90 dB bar; PERF.md)
        post = (jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
                if dtype == jnp.float32 else jax.lax.Precision.HIGHEST)
        self.audio = PolyResampler(L2, M2, t2, dtype, precision=post)

        # stage 4: de-emphasis as exact exponential-FIR projection
        if cfg.deemphasis_us > 0:
            a = math.exp(-1.0 / (cfg.audio_rate * cfg.deemphasis_us * 1e-6))
            K = max(8, int(math.ceil(math.log(1e-12) / math.log(a))))
            # PolyResampler computes y[m] = Σ_k h[k]·x[m−k]: h[k] weights the
            # sample k steps in the past, so h[k] = (1−a)·aᵏ as-is
            taps = (1.0 - a) * a ** np.arange(K, dtype=np.float64)
            self.deemph = PolyResampler(1, 1, taps, dtype, precision=post)
        else:
            self.deemph = None

        self.gain = dtype(quad / (2.0 * math.pi * cfg.deviation))

        # block geometry: complex samples per block such that every stage
        # yields a static, integral output length
        unit = self._block_unit()
        target = int(cfg.resolved_block_seconds() * fs)
        self.block_complex = max(unit, (target // unit) * unit)
        self.block_bytes = 2 * self.block_complex
        q_len = self.block_complex * self.chan.L // self.chan.M
        self.audio_per_block = (q_len // 2) * self.audio.L // self.audio.M

        # framed front end + matmul-split discriminator pairs: the flat
        # chan path pays a device-side flat→framed relayout and the
        # interleaved discriminator a stride-2/4 deinterleave; framed2
        # splits even/odd in the decimator's HOST tap matrices instead.
        # Eligible whenever the decimator is a pure L==1 banded matmul,
        # the block is whole frames, and outputs pair up within a frame.
        self._stride = (self.chan.chunk * self.chan.M
                        if self.chan.kernel is None and self.chan.L == 1
                        else 0)
        self._use_framed = bool(
            self._stride and self.block_complex % self._stride == 0
            and self.chan.chunk % 2 == 0)

    def _block_unit(self) -> int:
        """Smallest complex-sample count giving integral lengths everywhere."""
        c = self.chan
        a = self.audio
        # T·L1 % M1 == 0 ; (T·L1/M1) % 2 == 0 ; (T·L1/M1/2)·L2 % M2 == 0
        u = c.M // math.gcd(c.L, c.M)
        while True:
            q = u * c.L // c.M
            if q % 2 == 0 and (q // 2 * a.L) % a.M == 0:
                return u
            u += c.M // math.gcd(c.L, c.M)

    # -- state ----------------------------------------------------------
    def init_state(self, batch_shape=()) -> WbfmState:
        return WbfmState(
            chan_hist=self.chan.init_hist((*batch_shape, 2)),
            audio_hist=self.audio.init_hist(batch_shape),
            deemph_hist=(self.deemph.init_hist(batch_shape)
                         if self.deemph else jnp.zeros((*batch_shape, 1),
                                                       self.dtype)),
        )

    # -- forward ---------------------------------------------------------
    def __call__(self, state: WbfmState, raw: jax.Array):
        """raw: uint8 [..., block_bytes] → (state, audio [..., audio_per_block])."""
        n = raw.shape[-1]
        assert n == self.block_bytes, (n, self.block_bytes)
        lead = raw.shape[:-1]
        if self.cfg.conditioning == "normalize":
            x = cond_ops.normalize_input(raw, self.dtype)
        else:
            x = cond_ops.shift_origin(raw, self.dtype)
        iq = x.reshape(*lead, n // 2, 2)          # [..., T, 2]
        iq = jnp.swapaxes(iq, -1, -2)             # [..., 2, T]
        return self._forward(state, iq, lead)

    def call_u16(self, state: WbfmState, u16: jax.Array):
        """Fast entry: u16 [..., T] = the raw bytes host-viewed as uint16
        (numpy ``.view(np.uint16)`` — free).  Each u16 holds one complex
        sample (little-endian: low byte = I), so the deinterleave becomes
        elementwise mask/shift instead of the device-side pair-pack
        __call__ pays."""
        lead = u16.shape[:-1]
        bi = (u16 & jnp.uint16(0xFF)).astype(jnp.int32)
        bq = (u16 >> 8).astype(jnp.int32)
        # split2 decimator: materialize the framed planes directly in bf16
        # (lossless for the integer "shift" signal) — the decimator dots
        # read bf16 operands anyway, so this halves the biggest
        # intermediate's HBM write+read (19.2 → 9.6 MB per 1 s block)
        lane_dt = (jnp.bfloat16
                   if self._use_framed and self.chan._split2 else self.dtype)
        if self.cfg.conditioning == "normalize":
            denom = self.dtype(np.float32(2.0 / 255.0))
            xi = bi.astype(self.dtype) * denom - self.dtype(1.0)
            xq = bq.astype(self.dtype) * denom - self.dtype(1.0)
        else:
            xi = jnp.where(bi == 255, -128, bi - 127).astype(lane_dt)
            xq = jnp.where(bq == 255, -128, bq - 127).astype(lane_dt)
        if self._use_framed:
            # frame each lane BEFORE stacking: per-lane [T]→[R, stride] + a
            # stack writes the final layout directly, where a
            # barrier-pinned flat [2, T] would be copied again by the
            # [2, R, stride] reshape
            R = self.block_complex // self._stride
            iqf = jnp.stack([xi.reshape(*lead, R, self._stride),
                             xq.reshape(*lead, R, self._stride)], axis=-3)
            iqf = jax.lax.optimization_barrier(iqf)
            return self._forward_framed(state, iqf, lead)
        iq = jnp.stack([xi, xq], axis=-2)         # [..., 2, T]
        # materialize, so the decimation dot reads a plain operand instead
        # of a fused byte-unpack producer
        iq = jax.lax.optimization_barrier(iq)
        return self._forward(state, iq, lead)

    def _forward(self, state: WbfmState, iq: jax.Array, lead):
        if self._use_framed:
            R = self.block_complex // self._stride
            iqf = iq.reshape(*lead, 2, R, self._stride)
            return self._forward_framed(state, iqf, lead)
        ciq, chan_hist = self.chan(iq, state.chan_hist)
        # interleave back for the discriminator's pair layout
        inter = jnp.swapaxes(ciq, -1, -2).reshape(*lead, -1)
        d = demod_ops.fm_demod(inter, fast=True) * self.gain
        return self._post(state, d, chan_hist)

    def _forward_framed(self, state: WbfmState, iqf: jax.Array, lead):
        ye, yo, chan_hist = self.chan.framed2(iqf, state.chan_hist)
        d = demod_ops.fm_demod_split(
            ye[..., 0, :, :], ye[..., 1, :, :],
            yo[..., 0, :, :], yo[..., 1, :, :], fast=True)
        d = (d * self.gain).reshape(*lead, -1)
        return self._post(state, d, chan_hist)

    def _post(self, state: WbfmState, d: jax.Array, chan_hist):
        audio, audio_hist = self.audio(d, state.audio_hist)
        if self.deemph is not None:
            audio, deemph_hist = self.deemph(audio, state.deemph_hist)
        else:
            deemph_hist = state.deemph_hist
        return WbfmState(chan_hist, audio_hist, deemph_hist), audio

    # -- multi-station sharding -------------------------------------------
    def shard_over(self, mesh, state: WbfmState):
        """Multi-station DP: place a [C]-leading station batch's state over
        the mesh's chan axis; returns (sharded_state, chan_sharding) for
        jit donate/out_shardings.  Every stage is per-station (all
        histories lead with the batch axis from init_state((C,))), so the
        bank runs SPMD with zero communication — the same pattern as
        channel_bank.shard_over's mixer path.  Used by the CLI's
        ``--wbfm --inputs f1,..,fC [--shard-chan N]`` station bank."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import CHAN_AXIS
        chan = NamedSharding(mesh, P(CHAN_AXIS))
        state = jax.tree.map(lambda a: jax.device_put(a, chan), state)
        return state, chan
