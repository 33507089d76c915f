"""jnp application of the extracted affine filter operators.

Applies demodulator_tpu.ops.fir's RealFirOp / CplxFirOp on device as a
handful of shifted multiply-adds (the stationary taps, D+1 ≤ ~6 shifts) plus
two tiny dense corrections (head rows, overrun rows) — elementwise work
that XLA fuses into the surrounding pipeline.  Everything broadcasts
over leading batch dimensions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .fir import RealFirOp, CplxFirOp

__all__ = ["JRealFir", "JCplxFir"]


def _np_of(dtype) -> np.dtype:
    """numpy dtype for a jnp dtype (host-side constant storage)."""
    return np.dtype(jnp.dtype(dtype).name)


class JRealFir:
    """Device-ready real-filter operator (audio path)."""

    def __init__(self, op: RealFirOp, dtype=jnp.float32):
        self.H = op.H
        self.Wh = op.Wh
        self.D = op.D
        self.dtype = dtype
        # ALL constants live as HOST numpy: a jnp array closed over by a
        # jitted function is materialized back to the host at LOWERING
        # time (mlir ir_constant → Array._value, a device→host transfer);
        # numpy constants lower with zero device traffic
        self.taps = np.asarray(op.taps, _np_of(dtype))
        # Dense head rows concentrate the recurrence's cancellation into one
        # dot product (coefficients ~1/k^2): evaluate them in f64 (tiny work)
        self.head = np.asarray(op.head, np.float64)
        self.y_coup = None if op.y_coup is None else np.asarray(op.y_coup,
                                                                np.float64)

    def __call__(self, x: jax.Array, y_init: jax.Array | None = None) -> jax.Array:
        """x: [..., P] → y: [..., P].  y_init: [..., Ky] arena corruption."""
        P = x.shape[-1]
        assert P >= self.Wh, "block too small for filter head"
        pad = [(0, 0)] * (x.ndim - 1) + [(0, self.D)]
        xp = jnp.pad(x, pad)
        y = self.taps[0] * x
        for d in range(1, self.D + 1):
            y = y + self.taps[d] * xp[..., d: d + P]
        head_out = jnp.einsum("hw,...w->...h", self.head,
                              x[..., : self.Wh].astype(jnp.float64))
        y = jnp.concatenate([head_out.astype(self.dtype), y[..., self.H:]],
                            axis=-1)
        if y_init is not None and self.y_coup is not None and self.y_coup.shape[0]:
            hy = self.y_coup.shape[0]
            add = jnp.einsum("hk,...k->...h", self.y_coup,
                             y_init.astype(jnp.float64)).astype(self.dtype)
            y = jnp.concatenate([y[..., :hy] + add, y[..., hy:]], axis=-1)
        return y

    def stationary(self, x: jax.Array, halo: jax.Array | None = None) -> jax.Array:
        """Continuous-profile application: pure stationary anti-causal FIR.

        ``halo`` carries the first D samples of the *next* time shard (zeros
        at stream end).  No head rows / overruns — continuous mode removes
        the reference's per-block boundary artifacts by design.
        """
        P = x.shape[-1]
        if halo is None:
            halo = jnp.zeros((*x.shape[:-1], self.D), dtype=x.dtype)
        xe = jnp.concatenate([x, halo[..., : self.D]], axis=-1)
        y = self.taps[0] * x
        for d in range(1, self.D + 1):
            y = y + self.taps[d] * xe[..., d: d + P]
        return y


class JCplxFir:
    """Device-ready complex (I/Q-lane) filter operator."""

    def __init__(self, op: CplxFirOp, y_coup=None, dtype=jnp.float32):
        self.Hc, self.Whc = op.Hc, op.Whc
        self.Dc, self.Kc, self.Wtc = op.Dc, op.Kc, op.Wtc
        self.sos_len = op.sos_len
        self.dtype = dtype
        # host numpy constants throughout — see JRealFir.__init__
        self.taps = np.asarray(op.taps, _np_of(dtype))
        # dense corrections in f64 (see JRealFir): head, overrun, couplings
        self.head = np.asarray(op.head, np.float64)
        self.tail = np.asarray(op.tail, np.float64)
        self.tail_alias = np.asarray(op.tail_alias, np.float64)
        self.c_head = np.asarray(np.stack([op.c_head_i, op.c_head_q], -1),
                                 np.float64)
        self.c_int = np.asarray([op.c_int_i, op.c_int_q], _np_of(dtype))
        self.c_tail = np.asarray(np.stack([op.c_tail_i, op.c_tail_q], -1),
                                 np.float64)
        if y_coup is None:
            self.yc_head = self.yc_tail = None
        else:
            yc_head, yc_tail = y_coup
            # interleaved rows → [pairs, lane, K]
            self.yc_head = np.asarray(
                yc_head.reshape(-1, 2, yc_head.shape[1]), np.float64)
            self.yc_tail = np.asarray(
                yc_tail.reshape(-1, 2, yc_tail.shape[1]), np.float64)

    def __call__(self, x: jax.Array, y_init: jax.Array | None = None):
        """x: [..., S, 2] complex-sample pairs → (y [..., S, 2],
        overrun [..., Kc, 2]).  y_init: [..., Ky] interleaved reals."""
        S = x.shape[-2]
        assert S >= self.Whc + self.Wtc
        pad = [(0, 0)] * (x.ndim - 2) + [(0, self.Dc), (0, 0)]
        xp = jnp.pad(x, pad)
        y = self.taps[0] * x
        for d in range(1, self.Dc + 1):
            y = y + self.taps[d] * xp[..., d: d + S, :]
        y = y + self.c_int
        xh = x[..., : self.Whc, :].astype(jnp.float64)
        head_out = (jnp.einsum("hw,...wl->...hl", self.head, xh)
                    + self.c_head).astype(self.dtype)
        over = (jnp.einsum("kw,...wl->...kl", self.tail,
                           x[..., S - self.Wtc:, :].astype(jnp.float64))
                + jnp.einsum("kw,...wl->...kl", self.tail_alias, xh)
                + self.c_tail).astype(self.dtype)
        y = jnp.concatenate([head_out, y[..., self.Hc:, :]], axis=-2)
        if y_init is not None and self.yc_head is not None:
            yi64 = y_init.astype(jnp.float64)
            add_h = jnp.einsum("plk,...k->...pl", self.yc_head,
                               yi64).astype(self.dtype)
            add_t = jnp.einsum("plk,...k->...pl", self.yc_tail,
                               yi64).astype(self.dtype)
            hp = add_h.shape[-2]
            tc = 2 * self.sos_len  # final consumed pairs with alias coupling
            assert hp + tc <= S, "block too small for y_init coupling"
            y = jnp.concatenate([y[..., :hp, :] + add_h, y[..., hp:, :]],
                                axis=-2)
            y_tail_add, over_add = add_t[..., :tc, :], add_t[..., tc:, :]
            y = jnp.concatenate(
                [y[..., : S - tc, :], y[..., S - tc:, :] + y_tail_add], axis=-2)
            over = over + over_add
        return y, over

    def stationary(self, x: jax.Array, halo: jax.Array | None = None) -> jax.Array:
        """Continuous-profile application (see JRealFir.stationary).

        x: [..., S, 2]; halo: [..., Dc, 2] from the next time shard.
        Keeps the interior affine constants (the Q lane's -per-section
        constant is part of the reference's steady-state response)."""
        S = x.shape[-2]
        if halo is None:
            halo = jnp.zeros((*x.shape[:-2], self.Dc, 2), dtype=x.dtype)
        xe = jnp.concatenate([x, halo[..., : self.Dc, :]], axis=-2)
        y = self.taps[0] * x
        for d in range(1, self.Dc + 1):
            y = y + self.taps[d] * xe[..., d: d + S, :]
        return y + self.c_int
