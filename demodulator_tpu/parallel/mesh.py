"""Device-mesh construction for the demodulator framework.

Two mesh axes map the workload's parallelism (SURVEY.md §2.10):

  * ``chan`` — data parallelism over independent NBFM channels (a
    channelizer bank; BASELINE config 4);
  * ``time`` — sequence parallelism over time-blocks of one long IQ stream
    (BASELINE config 3).  Zero-communication in the compat profile (the
    reference zeroes filter state per block — SURVEY.md §1 fact 3); the
    continuous profile exchanges anti-causal FIR halos via ppermute.

Multi-process: call jax.distributed.initialize() before make_demod_mesh;
the mesh spans all processes' devices.  The mesh follows the algorithm
alone: the GPUs of one host are joined all to all by NVLink, so no device
order is better than another.
"""
from __future__ import annotations

import jax
import numpy as np

TIME_AXIS = "time"
CHAN_AXIS = "chan"

__all__ = ["make_demod_mesh", "TIME_AXIS", "CHAN_AXIS"]


def make_demod_mesh(n_time: int | None = None, n_chan: int | None = None,
                    devices=None) -> jax.sharding.Mesh:
    """Build a (time, chan) mesh over the available devices.

    With no arguments, uses all devices on the time axis (the common
    single-stream case).  n_time * n_chan must equal the device count.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_time is None and n_chan is None:
        n_time, n_chan = n, 1
    elif n_time is None:
        n_time = n // n_chan
    elif n_chan is None:
        n_chan = n // n_time
    if n_time * n_chan != n:
        raise ValueError(f"mesh {n_time}x{n_chan} != {n} devices")
    return jax.sharding.Mesh(devices.reshape(n_time, n_chan),
                             (TIME_AXIS, CHAN_AXIS))
