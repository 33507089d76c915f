"""Multi-host (multi-process) bring-up and global-array helpers.

The reference has no distributed backend at all (no MPI/NCCL anywhere in
its tree — SURVEY.md §2.10); this framework's communication layer is XLA
collectives (NCCL over NVLink between the GPUs of one host, the network
across hosts), reached through a global device mesh.  One process can
drive every card of a host; several processes join one mesh like this:

    1. every process calls :func:`init_distributed` first with the
       coordinator address, process count and its own process id;
    2. :func:`demodulator_tpu.parallel.mesh.make_demod_mesh` then spans
       *all* processes' devices (``jax.devices()`` is global after init);
    3. each host turns the bytes it read locally into its shards of the
       global [C, NB, n] chunk via :func:`host_chunk` /
       :func:`replicated_chunk`;
    4. ``ShardedPipeline`` runs the same SPMD step as single-host — XLA
       routes the correctIq all_gather / continuous-mode ppermute halos
       between the devices automatically.

Deployment note: for the time-sharded single-stream case each host should
read only its own slice of the capture (block index range
``process_index·NB_local … +NB_local``); :func:`host_chunk` assembles the
global array from exactly those local bytes with zero cross-host copies at
input time.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "host_chunk", "replicated_chunk"]

_ENV_PREFIX = "DEMODULATOR_TPU_"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> None:
    """Initialize JAX's multi-process runtime (idempotent).

    Pass the coordinator address (``host:port``), process count and this
    process's id explicitly or through the environment:
    ``DEMODULATOR_TPU_COORDINATOR``, ``DEMODULATOR_TPU_NUM_PROCESSES``,
    ``DEMODULATOR_TPU_PROCESS_ID``; nothing is auto-detected on a GPU
    host.  ``local_device_ids`` pins this process to some of the host's
    cards (one process per card: a JAX process reserves most of the
    memory of every card it opens).
    """
    # idempotency probe must not touch the XLA backend (jax.process_count()
    # would initialize it and make distributed init impossible)
    from jax._src import distributed as _dist
    if _dist.global_state.client is not None:
        return  # already initialized
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get(_ENV_PREFIX + "COORDINATOR"))
    if num_processes is None and _ENV_PREFIX + "NUM_PROCESSES" in env:
        num_processes = int(env[_ENV_PREFIX + "NUM_PROCESSES"])
    if process_id is None and _ENV_PREFIX + "PROCESS_ID" in env:
        process_id = int(env[_ENV_PREFIX + "PROCESS_ID"])
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kwargs)


def host_chunk(mesh: jax.sharding.Mesh, local: np.ndarray,
               spec: P) -> jax.Array:
    """Assemble a global array from THIS process's local shard data.

    ``local`` must be exactly this process's contiguous slice of the
    global array under ``spec`` (e.g. its own NB_local time blocks).  No
    cross-host data movement happens — each host's bytes go straight to
    its own devices.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local)


def replicated_chunk(mesh: jax.sharding.Mesh, full: np.ndarray,
                     spec: P) -> jax.Array:
    """Assemble a global array when every process holds the FULL array
    (convenient for small state like the correctIq offsets, and for
    tests).  Each device receives only its own shard slice of ``full``."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        full.shape, sharding, lambda idx: full[idx])
