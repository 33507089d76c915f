"""SPMD sharded demodulation over a (time, chan) device mesh.

The unit of work is a CHUNK: uint8 IQ of shape [C, NB, n] — C channels ×
NB blocks × bufSize bytes — sharded C over ``chan`` and NB over ``time``.

compat profile
    Blocks are independent (per-block zero filter state, SURVEY.md §1
    fact 3) → pure SPMD, zero communication … except conditioning mode 1
    (correctIq), whose DC tracker chains sequentially through every block of
    a channel.  Because the tracker is affine, each block's contribution
    reduces to a 2-vector summary; shards compute local prefixes, exchange
    one tiny summary via all_gather over ``time``, and fix their outputs up
    with a geometric decay profile — an exact (to fp) reconstruction of the
    sequential chain with O(1) communication.

continuous profile (extension; BASELINE config 3)
    The whole stream is filtered with the stationary interior response (no
    per-block transients).  The extracted FIR taps are anti-causal with tiny
    reach D, so each shard only needs the FIRST few samples of its RIGHT
    neighbor: one ppermute per filter stage.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import DemodConfig
from ..models.nbfm import BlockPipeline
from ..ops import conditioning as cond_ops
from ..ops import demod as demod_ops
from .mesh import TIME_AXIS, CHAN_AXIS

__all__ = ["ShardedPipeline"]


# exclusive affine prefix over the local block axis — shared with the
# single-chip batched path (models.nbfm.BlockPipeline.process_blocks)
_affine_prefix_blocks = cond_ops.correct_iq_block_prefix


def _cross_shard_offset(summary, off0, axis: str):
    """Turn per-shard affine summaries into each shard's incoming state via
    one all_gather of 2-vectors over the time axis."""
    A_loc, b_loc = summary                      # [..., 2] each (per channel)
    A_all = jax.lax.all_gather(A_loc, axis)     # [T, ..., 2]
    b_all = jax.lax.all_gather(b_loc, axis)
    t = jax.lax.axis_index(axis)
    T = A_all.shape[0]
    cur = off0
    states = []
    for j in range(T):                          # T is static and small
        states.append(cur)                      # state entering shard j
        cur = A_all[j] * cur + b_all[j]
    off = jax.lax.dynamic_index_in_dim(jnp.stack(states), t, keepdims=False)
    return off, cur


def _right_halo(x: jax.Array, width: int, axis_name: str, axis: int = -1,
                last=None):
    """Fetch the first ``width`` elements (along ``axis``) of the RIGHT
    neighbor's shard.  The LAST shard gets ``last`` (the continuation of
    the stream beyond this chunk) when provided, else zeros (stream end ≡
    zero padding)."""
    n = jax.lax.axis_size(axis_name)
    head = jax.lax.slice_in_dim(x, 0, width, axis=axis)
    if n == 1:
        return jnp.zeros_like(head) if last is None else last
    # send my head to my LEFT neighbor: src i → dst i-1 (last shard gets 0)
    perm = [(i, i - 1) for i in range(1, n)]
    out = jax.lax.ppermute(head, axis_name, perm)
    if last is not None:
        is_last = jax.lax.axis_index(axis_name) == n - 1
        out = jnp.where(is_last, last, out)
    return out


class ShardedPipeline:
    """Sharded (time × chan) demodulation step for one chunk.

    __call__(off0, raw) with raw uint8 [C, NB, n] (global shape) sharded
    P(chan, time, None) and off0 [C, 2] sharded P(chan, None); returns
    (new_off [C, 2], audio [C, NB, n/4] sharded like raw).
    """

    def __init__(self, cfg: DemodConfig, mesh: jax.sharding.Mesh,
                 fast_atan2: bool = False):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.pipe = BlockPipeline(cfg, fast_atan2=fast_atan2)
        self.continuous = cfg.profile == "continuous"
        n = cfg.buf_size
        self.decay = cond_ops.correct_iq_decay(n, self.pipe.esr,
                                               self.pipe.dtype)
        self._step = jax.jit(shard_map(
            self._local_step, mesh=mesh,
            in_specs=(P(CHAN_AXIS, None), P(CHAN_AXIS, TIME_AXIS, None)),
            out_specs=(P(CHAN_AXIS, None), P(CHAN_AXIS, TIME_AXIS, None)),
            check_vma=False))
        # continuous streaming: same step, plus the NEXT chunk's first block
        # (replicated) feeding the LAST time shard's halos so chunk
        # boundaries carry real data, not zero padding
        self._step_cont = jax.jit(shard_map(
            self._local_step_cont, mesh=mesh,
            in_specs=(P(CHAN_AXIS, None), P(CHAN_AXIS, TIME_AXIS, None),
                      P(CHAN_AXIS, None), P(None)),
            out_specs=(P(CHAN_AXIS, None), P(CHAN_AXIS, TIME_AXIS, None)),
            check_vma=False)) if self.continuous else None

    def __call__(self, off0: jax.Array, raw: jax.Array):
        return self._step(off0, raw)

    def step_continuous(self, off0: jax.Array, raw: jax.Array,
                        next_blk: jax.Array, has_next: jax.Array):
        """Continuous-profile chunk step with a cross-chunk halo: next_blk
        is the NEXT chunk's first raw block [C, n] (replicated over the
        mesh); has_next is a replicated [1] array of 1.0/0.0 (0 at stream
        end → zero halo, matching __call__)."""
        return self._step_cont(off0, raw, next_blk, has_next)

    # ---- conditioning with cross-shard correctIq ----------------------
    def _condition_sharded(self, off0, raw, dc_last=None):
        """raw [C_l, NB_l, n] → (cond [C_l, NB_l, n], dc_over|None, new_off).

        ``dc_last``: the LAST time shard's DC-filter halo (the next chunk's
        first shifted pairs), continuous kind-2 streaming only."""
        kind = self.cfg.conditioning_kind()
        pipe = self.pipe
        if kind == 1:
            out0, b_tot = cond_ops.correct_iq_zero(raw, pipe.esr, pipe.dtype)
            a_tot = (self.decay[-1] * self.decay[1]).astype(pipe.dtype)
            off_before, summary = _affine_prefix_blocks(a_tot, b_tot,
                                                        jnp.zeros_like(off0))
            off_sh, final = _cross_shard_offset(summary, off0, TIME_AXIS)
            # incoming shard state folds into every block's offset
            nb = raw.shape[-2]
            a_pow = a_tot ** jnp.arange(nb, dtype=pipe.dtype)
            off_blk = off_before + a_pow[:, None] * off_sh[..., None, :]
            cond = cond_ops.correct_iq_apply_offset(out0, off_blk, self.decay)
            return cond, None, final
        if kind == 2:
            shifted = cond_ops.shift_origin(raw, pipe.dtype)
            pairs = shifted.reshape(*shifted.shape[:-1],
                                    shifted.shape[-1] // 2, 2)
            if self.continuous:
                flat = pairs.reshape(pairs.shape[0], -1, 2)
                halo = _right_halo(flat, pipe.dc_fir.Dc, TIME_AXIS, axis=-2,
                                   last=dc_last)
                y = pipe.dc_fir.stationary(flat, halo)
                return y.reshape(raw.shape), None, off0
            y, over = pipe.dc_fir(pairs)
            return (y.reshape(raw.shape),
                    over.reshape(*over.shape[:-2], -1), off0)
        if kind == 3:
            return cond_ops.normalize_input(raw, pipe.dtype), None, off0
        return cond_ops.shift_origin(raw, pipe.dtype), None, off0

    def _next_stage_halos(self, next_blk, has_next, final_off):
        """Per-stage heads of the NEXT chunk's first block, feeding the
        LAST time shard's halos (cross-chunk stream continuity).

        Only the head of the conditioned block is filtered (pipe.halo_pairs
        covers every stage's reach), so the replicated extra work is the
        conditioning of one block — correctIq's two-ended tracker order
        (src/matrix.c:120-140) needs the whole block even for its head.
        Returns (in_fir halo [C, Dc, 2] | None, demod halo [C, D])."""
        pipe = self.pipe
        kind = self.cfg.conditioning_kind()
        C = next_blk.shape[0]
        if kind == 1:
            cond_n, _ = cond_ops.correct_iq(next_blk, final_off, pipe.esr,
                                            pipe.dtype)
        elif kind == 3:
            cond_n = cond_ops.normalize_input(next_blk, pipe.dtype)
        else:
            cond_n = cond_ops.shift_origin(next_blk, pipe.dtype)
        pairs = cond_n.reshape(C, -1, 2)[:, : pipe.halo_pairs]
        if pipe.dc_fir is not None:
            pairs = pipe.dc_fir.stationary(pairs)   # invalid tail only
        in_last = None
        if pipe.in_fir is not None:
            in_last = pairs[:, : pipe.in_fir.Dc] * has_next
            pairs = pipe.in_fir.stationary(pairs)
        d = demod_ops.fm_demod(pairs.reshape(C, -1), fast=pipe.fast_atan2)
        out_last = d[:, : pipe.out_fir.D] * has_next
        return in_last, out_last

    # ---- the per-shard step -------------------------------------------
    def _local_step(self, off0, raw):
        return self._local_step_impl(off0, raw, None, None)

    def _local_step_cont(self, off0, raw, next_blk, has_next):
        return self._local_step_impl(off0, raw, next_blk, has_next[0])

    def _local_step_impl(self, off0, raw, next_blk, has_next):
        pipe = self.pipe
        dc_last = None
        if next_blk is not None and self.continuous and pipe.dc_fir is not None:
            shifted_n = cond_ops.shift_origin(next_blk, pipe.dtype)
            dc_last = (shifted_n.reshape(raw.shape[0], -1, 2)
                       [:, : pipe.dc_fir.Dc] * has_next)
        cond, dc_over, new_off = self._condition_sharded(off0, raw, dc_last)
        if not self.continuous:
            audio = pipe.post_condition(cond, dc_over)
            return new_off, audio
        in_last = out_last = None
        if next_blk is not None:
            in_last, out_last = self._next_stage_halos(next_blk, has_next,
                                                       new_off)
        # continuous: flatten local blocks into one stream segment
        C = raw.shape[0]
        n = self.cfg.buf_size
        flat = cond.reshape(C, -1)
        if pipe.in_fir is not None:
            pairs = flat.reshape(C, -1, 2)
            halo = _right_halo(pairs, pipe.in_fir.Dc, TIME_AXIS, axis=-2,
                               last=in_last)
            y = pipe.in_fir.stationary(pairs, halo)
            flat = y.reshape(C, -1)
        d = demod_ops.fm_demod(flat, fast=pipe.fast_atan2)
        halo_d = _right_halo(d, pipe.out_fir.D, TIME_AXIS, axis=-1,
                             last=out_last)
        audio = pipe.out_fir.stationary(d, halo_d)
        return new_off, audio.reshape(C, raw.shape[1], n >> 2)
