"""Multi-channel NBFM bank (BASELINE config 4 — framework extension).

One wideband uint8 IQ capture → N simultaneous NBFM channels:

    conditioning (shiftOrigin semantics, src/matrix.c:82-98)
      → complex mixer bank: per-channel frequency shift by a precomputed
        [C, T] cos/sin LUT (host float64 at build time; zero runtime
        transcendentals) × a per-channel carry phasor for block continuity
      → per-channel decimation fs → channel_rate (framed-matmul
        PolyResampler broadcast over [C, iq] — matmul work)
      → quadrature discriminator (conj-product + atan2, 2:1 decim,
        src/matrix.c:159-176 semantics)
      → reference-designed audio lowpass (§2.4 Butterworth/Cheby-I SOS →
        stationary FIR taps), applied causally with a constant D-sample
        group delay via the streaming-FIR PolyResampler

The channel axis is embarrassingly parallel — it is the mesh's ``chan``
(data-parallel) axis; shard the leading [C] dim with
``parallel.mesh.make_demod_mesh`` + NamedSharding and every stage runs
SPMD with zero communication.  The reference has no channelizer at all
(single stream end-to-end, SURVEY.md §1); this model is the "DP over
channel banks" story of §2.10.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DemodConfig, default_block_seconds
from ..design.biquad import design_sos
from ..ops import conditioning as cond_ops
from ..ops import demod as demod_ops
from ..ops.fir import extract_real_fir
from ..ops.fir_apply import JRealFir
from ..ops.channelizer import PolyphaseChannelizer
from ..ops.resample import PolyResampler, design_resampler_taps

__all__ = ["ChannelBankConfig", "ChannelBankState", "ChannelBankPipeline"]


@dataclasses.dataclass
class ChannelBankConfig:
    sample_rate: float = 12288000.0      # wideband input rate (64 × 192 kHz)
    channel_rate: float = 192000.0       # per-channel complex rate
    offsets_hz: Sequence[float] = ()     # channel centers rel. to capture DC
    lowpass_out: float = 12500.0         # audio cutoff (reference -l)
    out_filter_degree: int = 3           # reference -d
    out_filter_family: int = 0           # 0 Butterworth, 1 Cheby-I
    epsilon: float = 0.3
    atten_db: float = 70.0
    # 0 ⇒ the backend's default (config.default_block_seconds)
    block_seconds: float = 0.0
    # "auto": polyphase FFT filterbank when every offset sits on the k·fs/C
    # grid (C = fs/channel_rate) — ~50× cheaper than per-channel mixing;
    # "mixer": force the arbitrary-offset mix+decimate path; "pfb": force
    # the filterbank (errors off-grid).
    method: str = "auto"

    def num_channels(self) -> int:
        return len(self.offsets_hz)

    def decim(self) -> int:
        d = self.sample_rate / self.channel_rate
        if abs(d - round(d)) > 1e-9:
            raise ValueError("sample_rate must be an integer multiple of "
                             "channel_rate")
        return int(round(d))

    def resolved_block_seconds(self) -> float:
        return self.block_seconds or default_block_seconds("bank")


class ChannelBankState(NamedTuple):
    phasor: jax.Array     # [C, 2] mixer carry (cos, −sin of accrued phase)
    chan_hist: jax.Array  # [C, 2, Hc] decimator history
    audio_hist: jax.Array  # [C, Ha] audio FIR history


class ChannelBankPipeline:
    """Jit-able per-block channel bank.  Output: [C, audio_per_block]."""

    def __init__(self, cfg: ChannelBankConfig, dtype=jnp.float32):
        if not cfg.offsets_hz:
            raise ValueError("offsets_hz must name at least one channel")
        self.cfg = cfg
        self.dtype = dtype
        fs = cfg.sample_rate
        D = cfg.decim()
        C = cfg.num_channels()

        self.method = cfg.method
        if self.method in ("auto", "pfb"):
            try:
                pfb = PolyphaseChannelizer(D)
                self.pfb_rows = np.asarray(
                    [pfb.channel_index(o, fs) for o in cfg.offsets_hz],
                    jnp.int32)
                self.pfb = pfb
                self.method = "pfb"
            except ValueError:
                if self.method == "pfb":
                    raise
                self.method = "mixer"

        # block geometry: wideband complex samples per block — multiple of
        # D with an even channel-rate count (discriminator pairs)
        unit = 2 * D
        target = int(cfg.resolved_block_seconds() * fs)
        self.block_complex = max(unit, (target // unit) * unit)
        self.block_bytes = 2 * self.block_complex
        T = self.block_complex
        self.chan_complex = T // D
        self.audio_per_block = self.chan_complex // 2

        if self.method == "pfb":
            # geometry above (T % 2D == 0) already guarantees frame alignment
            self._build_audio_chain(dtype)
            return

        # channel-select decimator (anti-alias at the channel Nyquist)
        taps = design_resampler_taps(1, D, fs,
                                     cutoff=0.45 * cfg.channel_rate,
                                     atten_db=cfg.atten_db)
        # dot precision, measured on an H100 (8 channels at 1.536 Msps,
        # audio vs the CPU at HIGHEST): TF32 (DEFAULT/HIGH) 58 dB, 3-pass
        # bf16 94 dB at the same step time, F32 118 dB at 1.7× the step.
        # 3-pass bf16 clears the banks' 80 dB bar (PERF.md)
        self.chan = PolyResampler(
            1, D, taps, dtype,
            precision=(jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
                       if dtype == jnp.float32
                       else jax.lax.Precision.HIGHEST))

        # mixer LUT: e^{−j·2π·f_c·n/fs} for n in [0, T), host float64 once.
        # When the block is a whole number of decimator frames the LUT is
        # stored pre-framed [C, R, stride] and the whole full-rate front
        # half runs in that layout (the flat→framed relayout of the [C,2,T]
        # mixed signal otherwise costs more than the decimation dots — see
        # PolyResampler.framed); otherwise the flat path is kept.
        stride = self.chan.chunk * D
        self.mixer_framed = (T % stride == 0) and self.chan.chunk % 2 == 0
        n = np.arange(T, dtype=np.float64)
        fr = np.asarray(cfg.offsets_hz, np.float64)[:, None] / fs
        theta = -2.0 * np.pi * (fr * n % 1.0)
        lut_shape = (C, T // stride, stride) if self.mixer_framed else (C, T)
        # host numpy constants (see ops/fir_apply.py JRealFir); the
        # sharded path device_puts them over the chan axis in shard_over
        ndt = np.dtype(jnp.dtype(dtype).name)
        self.lut_cos = np.cos(theta).reshape(lut_shape).astype(ndt)
        self.lut_sin = np.sin(theta).reshape(lut_shape).astype(ndt)
        # per-block phasor rotation e^{−j·2π·f_c·T/fs}
        rot = -2.0 * np.pi * (fr[:, 0] * T % 1.0)
        self.rot = np.asarray(np.stack([np.cos(rot), np.sin(rot)], -1),
                               dtype)                       # [C, 2]

        self._build_audio_chain(dtype)

    def _build_audio_chain(self, dtype):
        # audio filter: the reference's SOS design → stationary FIR taps
        # (JRealFir interior response), applied causally with group delay
        # equal to the anti-causal reach self.delay
        cfg = self.cfg
        sos = design_sos(cfg.out_filter_family, cfg.out_filter_degree,
                         cfg.lowpass_out, cfg.channel_rate, cfg.epsilon,
                         dtype=np.float64)
        fir = JRealFir(extract_real_fir(sos), dtype=dtype)
        causal = np.asarray(fir.taps, np.float64)[::-1].copy()
        self.audio = PolyResampler(1, 1, causal, dtype)
        self.delay = len(causal) - 1  # samples of constant audio latency

    # -- state ----------------------------------------------------------
    def init_state(self) -> ChannelBankState:
        C = self.cfg.num_channels()
        if self.method == "pfb":
            return ChannelBankState(
                phasor=jnp.zeros((0, 2), self.dtype),  # PFB needs no phasor
                chan_hist=self.pfb.init_hist(),
                audio_hist=self.audio.init_hist((C,)),
            )
        ph = jnp.zeros((C, 2), self.dtype).at[:, 0].set(1.0)
        return ChannelBankState(
            phasor=ph,
            chan_hist=self.chan.init_hist((C, 2)),
            audio_hist=self.audio.init_hist((C,)),
        )

    # -- forward ---------------------------------------------------------
    def __call__(self, state: ChannelBankState, raw: jax.Array):
        """raw: uint8 [block_bytes] → (state, audio [C, audio_per_block])."""
        assert raw.shape[-1] == self.block_bytes
        xi, xq = cond_ops.split_iq(raw, self.dtype)
        if self.method == "pfb":
            return self._forward_pfb(state, xi, xq)
        return self._forward_mixer(state, xi, xq)

    def call_u16(self, state: ChannelBankState, u16: jax.Array):
        """Fast entry: u16 [block_complex] = the raw bytes host-viewed as
        uint16 (numpy ``.view(np.uint16)`` — zero-copy; low byte = I).  The
        elementwise unpack replaces __call__'s device-side u8→u16 bitcast."""
        assert u16.shape[-1] == self.block_complex
        xi, xq = cond_ops.split_iq_u16(u16, self.dtype)
        if self.method == "pfb":
            return self._forward_pfb(state, xi, xq)
        return self._forward_mixer(state, xi, xq)

    def _forward_mixer(self, state, xi, xq):
        T = self.block_complex
        if self.mixer_framed:
            # frame the (small, pre-expansion) conditioned signal once;
            # every stage up to the decimation dot then stays in the
            # layout-friendly [.., R, stride] shape — no relayout of the
            # C×-expanded mixer output
            stride = self.chan.chunk * self.chan.M
            xi = xi.reshape(T // stride, stride)
            xq = xq.reshape(T // stride, stride)
            pc = state.phasor[:, :1, None]                  # [C, 1, 1]
            ps = state.phasor[:, 1:, None]
        else:
            pc, ps = state.phasor[:, :1], state.phasor[:, 1:]

        # mixer: (xi + j·xq) · (lut_c + j·lut_s) · (pc + j·ps).  The carry
        # phasor multiplies the LUT-mixed SIGNAL, not the LUT: rotating the
        # [C, T] LUTs per block would re-materialize 2·C·T floats every
        # step.  The reassociation only reorders f32 roundings (≤1 ulp on
        # the mixed signal)
        ui = xi * self.lut_cos - xq * self.lut_sin          # [C, ...]
        uq = xi * self.lut_sin + xq * self.lut_cos
        mi = ui * pc - uq * ps
        mq = ui * ps + uq * pc
        iq = jnp.stack([mi, mq], axis=1)
        # materialize the mixed signal, so the decimation dot reads a
        # plain operand instead of a fused elementwise producer
        iq = jax.lax.optimization_barrier(iq)

        if self.mixer_framed:
            # decimate with even/odd-split tap matrices: the discriminator
            # pairs arrive planar with zero device-side deinterleave
            # (ops/demod.fm_demod_split docstring)
            ye, yo, chan_hist = self.chan.framed2(iq, state.chan_hist)
            d = demod_ops.fm_demod_split(
                ye[:, 0], ye[:, 1], yo[:, 0], yo[:, 1], fast=True)
            d = d.reshape(d.shape[0], -1)                  # [C, Tc/2]
        else:
            ciq, chan_hist = self.chan(iq, state.chan_hist)
            inter = jnp.swapaxes(ciq, -1, -2).reshape(ciq.shape[0], -1)
            d = demod_ops.fm_demod(inter, fast=True)       # [C, Tc/2]
        audio, audio_hist = self.audio(d, state.audio_hist)

        # advance + renormalize the carry phasor (f32 drift control)
        pc0, ps0 = state.phasor[:, 0], state.phasor[:, 1]   # [C]
        npc = pc0 * self.rot[:, 0] - ps0 * self.rot[:, 1]
        nps = pc0 * self.rot[:, 1] + ps0 * self.rot[:, 0]
        norm = jax.lax.rsqrt(npc * npc + nps * nps)
        phasor = jnp.stack([npc * norm, nps * norm], axis=-1)
        return ChannelBankState(phasor, chan_hist, audio_hist), audio

    def _forward_pfb(self, state: ChannelBankState, xi, xq):
        iq = jnp.stack([xi, xq], axis=0)                    # [2, T]
        if self.block_complex % (2 * self.pfb.C) == 0:
            # split-parity einsum front: discriminator pairs arrive as
            # planar even/odd planes (ops/channelizer.call_split)
            yer, yei, yor, yoi, chan_hist = self.pfb.call_split(
                iq, state.chan_hist)
            d = demod_ops.fm_demod_split(yer, yei, yor, yoi,
                                         fast=True)        # [M2, Cgrid]
            d = jnp.take(d.T, self.pfb_rows, axis=0)        # [C, Tc/2]
        else:
            chans, chan_hist = self.pfb(iq, state.chan_hist)
            sel = jnp.take(chans, self.pfb_rows, axis=0)    # [C, 2, Tc]
            inter = jnp.swapaxes(sel, -1, -2).reshape(sel.shape[0], -1)
            d = demod_ops.fm_demod(inter, fast=True)
        audio, audio_hist = self.audio(d, state.audio_hist)
        return ChannelBankState(state.phasor, chan_hist, audio_hist), audio

    # -- sharding --------------------------------------------------------
    def shard_over(self, mesh, state: ChannelBankState):
        """Place the per-channel state (and, on the mixer path, the LUTs)
        over the mesh's chan axis; returns (sharded_state, out_sharding)
        for jit donate/out_shardings.

        Mixer method: everything is [C]-leading — LUTs, phasor, histories —
        so the whole bank is embarrassingly parallel over `chan`.  PFB
        method: the polyphase front end runs once on the wideband stream
        (its history is per-lane, not per-channel) and stays replicated;
        only the per-channel audio FIR history shards."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import CHAN_AXIS
        chan = NamedSharding(mesh, P(CHAN_AXIS))
        if self.method == "mixer":
            self.lut_cos = jax.device_put(self.lut_cos, chan)
            self.lut_sin = jax.device_put(self.lut_sin, chan)
            self.rot = jax.device_put(self.rot, chan)
            state = jax.tree.map(lambda a: jax.device_put(a, chan), state)
            return state, chan
        repl = NamedSharding(mesh, P())
        state = ChannelBankState(
            phasor=jax.device_put(state.phasor, repl),
            chan_hist=jax.device_put(state.chan_hist, repl),
            audio_hist=jax.device_put(state.audio_hist, chan))
        return state, chan
