"""NBFM demodulation pipeline — the framework's flagship model.

Composes the jnp equivalents of the reference consumer chain
(src/matrix.c:178-280):

    uint8 IQ block → conditioning → [complex affine-FIR (input LPF)]
                   → quadrature discriminator → real affine-FIR (audio LPF)

per 256 KiB block with zero filter state (compat profile), exactly modeling
the reference's arena couplings (filter overruns feeding the next stage's
initial y — see demodulator_tpu.ops.fir).  Everything is shape-static,
scan-free (conditioning mode 1 uses an associative scan), jit-friendly, and
broadcasts over leading batch dims for multi-block / multi-channel batching.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..design.biquad import design_sos, BUTTER_HP
from ..ops import conditioning as cond_ops
from ..ops import demod as demod_ops
from ..ops.fir import extract_real_fir, extract_cplx_fir
from ..ops.fir_apply import JRealFir, JCplxFir


class PipelineState(NamedTuple):
    """Carry state across blocks (the reference's only cross-block state is
    correctIq's static DC offsets, src/matrix.c:125)."""
    iq_off: jax.Array  # [..., 2] float


class BlockPipeline:
    """Builds and holds the jit-able per-block compute graph for a config."""

    def __init__(self, cfg: DemodConfig, fast_atan2: bool = False):
        cfg.validate()
        self.cfg = cfg
        self.fast_atan2 = fast_atan2
        self.dtype = jnp.float64 if cfg.precision == "float64" else jnp.float32
        np_dtype = cfg.np_dtype()
        self.in_degree = cfg.effective_in_filter_degree()
        kind = cfg.conditioning_kind()

        # --- DC-block conditioning filter (src/matrix.c:142-157) ---
        self.dc_fir = None
        dc_overrun = 0
        if kind == 2:
            sos_dc = design_sos(BUTTER_HP, 3, 1.0, cfg.sample_rate, 0.0,
                                dtype=np_dtype)
            op, _ = extract_cplx_fir(sos_dc, alias=False)
            self.dc_fir = JCplxFir(op, dtype=self.dtype)
            dc_overrun = 2 * op.Kc  # interleaved reals scribbled past region

        # --- input complex filter (-L) ---
        self.in_fir = None
        in_overrun = 0
        if cfg.lowpass_in:
            sos_in = design_sos(cfg.in_filter_family(), self.in_degree,
                                cfg.lowpass_in, cfg.sample_rate, cfg.epsilon,
                                dtype=np_dtype)
            op, y_coup = extract_cplx_fir(sos_in, alias=True,
                                          y_init_len=dc_overrun)
            self.in_fir = JCplxFir(op, y_coup, dtype=self.dtype)
            in_overrun = 2 * op.Kc

        # --- output (audio) real filter ---
        audio_y_init = in_overrun if self.in_fir is not None else dc_overrun
        sos_out = design_sos(cfg.out_filter_family(), cfg.out_filter_degree,
                             cfg.lowpass_out, cfg.sample_rate, cfg.epsilon,
                             dtype=np_dtype)
        self.out_fir = JRealFir(
            extract_real_fir(sos_out, y_init_len=audio_y_init),
            dtype=self.dtype)

        self.esr = np_dtype(50.0 / cfg.sample_rate)

    # -- continuous profile (BASELINE config 3) ---------------------------
    @property
    def halo_pairs(self) -> int:
        """Complex samples of the NEXT block's conditioned head that the
        stationary (anti-causal) filter chain needs to continue across a
        block boundary without per-block transients: 2 input pairs per
        audio-filter tap reach, plus each complex stage's own reach.
        Rounded up to even so the discriminator's 2:1 pairing never
        straddles the halo edge."""
        hp = 2 * self.out_fir.D
        if self.in_fir is not None:
            hp += self.in_fir.Dc
        if self.dc_fir is not None:
            hp += self.dc_fir.Dc
        return hp + (hp & 1)

    def condition_block(self, state: PipelineState, raw: jax.Array):
        """Conditioning stage alone: uint8 [..., n] → (new_state, cond).

        Split out for the continuous profile, where block k's filters need
        block k+1's CONDITIONED head: conditioning stays per-block (the
        correctIq tracker's two-ended order is defined over a block,
        src/matrix.c:120-140) while the filters become stationary.  kind 2
        conditions with shift_origin only — its DC-block highpass is a
        filter, so in the continuous profile it runs as a stationary stage
        of continuous_post (matching parallel.sharding's sharded step)."""
        kind = self.cfg.conditioning_kind()
        if kind == 1:
            out, off = cond_ops.correct_iq(raw, state.iq_off, self.esr,
                                           self.dtype)
            return PipelineState(iq_off=off), out
        if kind == 3:
            return state, cond_ops.normalize_input(raw, self.dtype)
        return state, cond_ops.shift_origin(raw, self.dtype)

    def continuous_post(self, cond: jax.Array, halo_cond: jax.Array):
        """Stationary filters + discriminator across the block boundary.

        cond: conditioned block [..., n]; halo_cond: the NEXT block's
        conditioned first 2·halo_pairs reals (zeros at stream end — the
        stationary filters see the stream as zero-padded beyond EOF).
        Returns audio [..., n/4] with no per-block transients: output
        sample i of any block equals the infinite-stream stationary
        response, because every stage's zero-halo error stays confined to
        the last ``reach`` samples of the extended buffer, beyond what the
        next stage consumes for the first n/4 outputs."""
        n = self.cfg.buf_size
        assert halo_cond.shape[-1] == 2 * self.halo_pairs
        ext = jnp.concatenate([cond, halo_cond], axis=-1)
        pairs = ext.reshape(*ext.shape[:-1], ext.shape[-1] // 2, 2)
        if self.dc_fir is not None:
            pairs = self.dc_fir.stationary(pairs)
        if self.in_fir is not None:
            pairs = self.in_fir.stationary(pairs)
        flat = pairs.reshape(*ext.shape)
        if self.cfg.demod_mode() == 0:
            return flat[..., :n]
        d = demod_ops.fm_demod(flat, fast=self.fast_atan2)
        audio = self.out_fir.stationary(d)
        return audio[..., : n >> 2]

    def continuous_halo(self, cond_next: jax.Array) -> jax.Array:
        """Slice the halo continuous_post wants from the next block's
        conditioned output: [..., n] → [..., 2·halo_pairs]."""
        return cond_next[..., : 2 * self.halo_pairs]

    # -- state ----------------------------------------------------------
    def init_state(self, batch_shape=()) -> PipelineState:
        return PipelineState(
            iq_off=jnp.zeros((*batch_shape, 2), dtype=self.dtype))

    # -- stages ---------------------------------------------------------
    def _condition(self, raw: jax.Array, state: PipelineState):
        """→ (conditioned [..., n], overrun|None, new_state)."""
        kind = self.cfg.conditioning_kind()
        if kind == 1:
            out, off = cond_ops.correct_iq(raw, state.iq_off, self.esr,
                                           self.dtype)
            return out, None, PipelineState(iq_off=off)
        if kind == 2:
            shifted = cond_ops.shift_origin(raw, self.dtype)
            pairs = shifted.reshape(*shifted.shape[:-1],
                                    shifted.shape[-1] // 2, 2)
            y, over = self.dc_fir(pairs)
            flat = y.reshape(*shifted.shape)
            over_flat = over.reshape(*over.shape[:-2], -1)
            return flat, over_flat, state
        if kind == 3:
            return cond_ops.normalize_input(raw, self.dtype), None, state
        return cond_ops.shift_origin(raw, self.dtype), None, state

    def post_condition(self, x: jax.Array, dc_over: jax.Array | None):
        """Filters + discriminator on conditioned data [..., n] → audio
        [..., n/4].  Split out so the sharding layer can substitute its own
        conditioning (demodulator_tpu.parallel.sharding)."""
        n = self.cfg.buf_size
        if self.in_fir is not None:
            pairs = x.reshape(*x.shape[:-1], n // 2, 2)
            y, in_over = self.in_fir(pairs, dc_over)
            demod_in = y.reshape(*x.shape[:-1], n)
            audio_y_init = in_over.reshape(*in_over.shape[:-2], -1)
        else:
            demod_in = x
            audio_y_init = dc_over
        d = demod_ops.fm_demod(demod_in, fast=self.fast_atan2)
        return self.out_fir(d, audio_y_init)

    def __call__(self, state: PipelineState, raw: jax.Array):
        """raw: uint8 [..., buf_size] → (new_state, audio [..., buf_size/4])
        (or filtered IQ [..., buf_size] in demod mode 0)."""
        cfg = self.cfg
        n = cfg.buf_size
        assert raw.shape[-1] == n
        if cfg.demod_mode() == 0:
            x = cond_ops.normalize_input(raw, self.dtype)
            pairs = x.reshape(*x.shape[:-1], n // 2, 2)
            y, _ = self.in_fir(pairs)
            return state, y.reshape(*x.shape[:-1], n)
        x, dc_over, state = self._condition(raw, state)
        return state, self.post_condition(x, dc_over)

    # -- conveniences ---------------------------------------------------
    def jit_block_fn(self):
        return jax.jit(self.__call__, donate_argnums=(0,))

    def process_blocks(self, state: PipelineState, raw: jax.Array):
        """raw: uint8 [B, n] → (state, audio [B, n/4]).

        Conditioning mode 1's DC tracker chains through every block, but
        the recurrence is affine, so the chain reduces to per-block
        2-vector summaries + a log-depth prefix over the block axis
        (cond_ops.correct_iq_block_prefix) — every block then conditions
        and demodulates in parallel instead of in a lax.scan over blocks.
        Every other mode is embarrassingly parallel outright (§1 fact 3 of
        SURVEY.md).
        """
        if self.cfg.conditioning_kind() != 1:
            return self(state, raw)
        n = self.cfg.buf_size
        decay = cond_ops.correct_iq_decay(n, self.esr, self.dtype)
        a_tot = (decay[-1] * decay[1]).astype(self.dtype)
        out0, b_tot = cond_ops.correct_iq_zero(raw, self.esr, self.dtype)
        off_before, (A, b) = cond_ops.correct_iq_block_prefix(
            a_tot, b_tot, state.iq_off)
        final = A * state.iq_off + b
        cond = cond_ops.correct_iq_apply_offset(out0, off_before, decay)
        audio = self.post_condition(cond, None)
        return PipelineState(iq_off=final), audio
