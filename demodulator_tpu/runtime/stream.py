"""Streaming runtime: double-buffered block feeder + pipelined device compute.

Replacement for the reference's producer/consumer thread pair
(src/main.c:58-98, src/matrix.c:236-242).  The pthread+semaphore ping-pong
becomes: a reader thread filling a bounded prefetch queue (the semaphore
pair's moral equivalent), the main thread dispatching async device work
(jit dispatch is non-blocking, so host reads overlap device compute), and a
small in-flight window before synchronizing outputs for the writer.

Framing semantics (compat profile):
  * only FULL bufSize blocks are processed — the reference drops partial
    tails via its exit-flag race (verified empirically; src/main.c:72-91);
  * each block's output is bufSize/4 float32 samples (src/matrix.c:193);
  * profile="continuous" / tail_policy="pad" extensions process the tail
    zero-padded.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from typing import BinaryIO, Iterator, Optional

import numpy as np

from ..config import DemodConfig
from ..models.nbfm import BlockPipeline

__all__ = ["BlockReader", "make_reader", "StreamProcessor",
           "ShardedStreamProcessor"]


class BlockReader:
    """Background-thread block reader with a bounded prefetch queue."""

    def __init__(self, f: BinaryIO, block_size: int, depth: int = 4,
                 tail_policy: str = "drop"):
        self.f = f
        self.block_size = block_size
        self.tail_policy = tail_policy
        self.q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            # keep last raw block around: the reference's short final read
            # overlays fresh bytes on the previous block's buffer
            prev = np.zeros(self.block_size, dtype=np.uint8)
            while True:
                data = self.f.read(self.block_size)
                if data is None:
                    # non-blocking source with nothing to give: the
                    # reference's "zero read, no EOF, no error" starvation
                    # (exitFlag -3, src/main.c:84-85)
                    raise BlockingIOError("starved input stream")
                if not data:
                    break
                buf = np.frombuffer(data, dtype=np.uint8)
                if len(buf) < self.block_size:
                    if self.tail_policy == "pad":
                        blk = prev.copy()
                        blk[: len(buf)] = buf
                        self.q.put(blk)
                    break  # "drop": partial tail never produces output
                prev = buf
                self.q.put(buf)
        except BaseException as e:  # surfaced to the consumer
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self.q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


def _seek_or_skip(f: BinaryIO, offset: int) -> None:
    """Position ``f`` at ``offset``: seek when possible, otherwise consume
    and discard (pipes/FIFOs — resumable live captures)."""
    try:
        f.seek(offset)
        return
    except (OSError, io.UnsupportedOperation):
        pass
    left = offset
    while left > 0:
        d = f.read(min(1 << 20, left))
        if not d:
            raise EOFError(
                f"input ended {left} bytes before the resume offset")
        left -= len(d)


def make_reader(fin: BinaryIO, block_bytes: int, tail_policy: str,
                offset: int = 0, use_native: bool = True):
    """Block-reader factory shared by every streaming entry (single-stream,
    --bank, resume): the native C++ ring-buffer reader (runtime/native) when
    the input is a real file or stdin, the Python BlockReader for any other
    BinaryIO.  Both yield identical full uint8 blocks; ``offset`` is handled
    inside whichever reader is chosen (the native one lseeks files and
    skip-reads pipes in C; the fallback seeks-or-skips ``fin`` itself).
    DEMODULATOR_TPU_NO_NATIVE=1 forces the Python reader."""
    if use_native and not os.environ.get("DEMODULATOR_TPU_NO_NATIVE"):
        import sys
        path = None
        if fin is sys.stdin.buffer:
            path = "-"
        else:
            name = getattr(fin, "name", None)
            if isinstance(name, str) and name not in ("<stdin>",):
                if os.path.exists(name):
                    path = name
        if path is not None:
            try:
                from . import native
                if native.available():
                    return native.NativeBlockReader(
                        path, block_bytes, tail_policy=tail_policy,
                        offset=offset)
            except Exception:
                pass  # fall back to the Python reader
    if offset:
        _seek_or_skip(fin, offset)
    return BlockReader(fin, block_bytes, tail_policy=tail_policy)


class ChunkReader:
    """Background-thread CHUNK reader: yields [NB, block_size] uint8 arrays
    read with a single readinto per chunk (no per-block stacking), plus a
    final partial chunk of whole blocks.  Tail semantics match BlockReader:
    a trailing partial block is dropped, or (``pad``) overlays the previous
    block's bytes (the reference's short-read buffer reuse, src/main.c:88).
    """

    def __init__(self, f: BinaryIO, block_size: int, nb: int,
                 depth: int = 2, tail_policy: str = "drop"):
        self.f = f
        self.block_size = block_size
        self.nb = nb
        self.tail_policy = tail_policy
        self.q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _read_full(self, view: memoryview) -> int:
        """readinto until the view is full or EOF; returns bytes read."""
        got = 0
        while got < len(view):
            r = self.f.readinto(view[got:])
            if r is None:
                raise BlockingIOError("starved input stream")  # → exit -3
            if r == 0:
                break
            got += r
        return got

    def _run(self):
        bb = self.block_size
        try:
            prev_tail = np.zeros(bb, dtype=np.uint8)
            while True:
                chunk = np.empty((self.nb, bb), dtype=np.uint8)
                got = self._read_full(memoryview(chunk).cast("B"))
                full, part = divmod(got, bb)
                if full == self.nb:
                    prev_tail[:] = chunk[-1]
                    self.q.put(chunk)
                    continue
                flat = chunk.reshape(-1)
                if part and self.tail_policy == "pad":
                    pad = (chunk[full - 1] if full else prev_tail).copy()
                    pad[:part] = flat[full * bb: full * bb + part]
                    self.q.put(np.concatenate([chunk[:full], pad[None]]))
                elif full:
                    self.q.put(chunk[:full].copy())
                break
        except BaseException as e:
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self.q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


class ShardedStreamProcessor:
    """Time-sharded streaming: one long IQ stream over a device mesh.

    Chunks of NB = n_time · blocks_per_shard blocks are sharded over the
    mesh's ``time`` axis and processed by parallel.sharding.ShardedPipeline
    (zero communication in the compat profile, except correctIq's O(1)
    affine-summary all_gather; ppermute FIR halos in continuous, with the
    next chunk's first block feeding the last shard's halo so chunk
    boundaries stay continuous).  The stream tail (fewer than NB blocks)
    falls back to the per-block pipeline carrying the same state, so output
    matches unsharded streaming to fp tolerance.

    Single-host: a background ChunkReader prefetches; device dispatch is
    async with an ``inflight`` window, so host IO overlaps device compute
    and the carry state never syncs to the host between chunks.

    Multi-host (reference producer scaled out, src/main.c:58-98): after
    parallel.distributed.init_distributed(), each process reads ONLY its
    own time-block ranges of the input file (zero cross-host input
    traffic, jax.make_array_from_process_local_data), the SPMD step runs
    over the global mesh, and process 0 gathers + writes the output.
    Requires a seekable file input.
    """

    def __init__(self, cfg: DemodConfig, n_time: int | None = None,
                 fast_atan2: bool = False, blocks_per_shard: int = 2,
                 mesh=None, inflight: int = 2, shared_output: bool = False):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import make_demod_mesh, TIME_AXIS
        from ..parallel.sharding import ShardedPipeline
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_demod_mesh(
            n_time=n_time, n_chan=1)
        n_t = self.mesh.devices.shape[0]
        self.NB = n_t * max(1, blocks_per_shard)
        self.continuous = cfg.profile == "continuous"
        self.sp = ShardedPipeline(cfg, self.mesh, fast_atan2=fast_atan2)
        self.block_bytes = cfg.buf_size
        self.inflight = max(1, inflight)
        self._raw_spec = P(None, TIME_AXIS, None)
        self._raw_sh = NamedSharding(self.mesh, self._raw_spec)
        self._off_sh = NamedSharding(self.mesh, P(None, None))
        self._rep_sh = NamedSharding(self.mesh, P(None, None))
        self._hn_sh = NamedSharding(self.mesh, P(None))
        self._jax = jax
        self.shared_output = shared_output
        self.n_proc = jax.process_count()
        if self.n_proc > 1:
            # this process's contiguous time-block range within a chunk
            idx = self._raw_sh.addressable_devices_indices_map(
                (1, self.NB, cfg.buf_size))
            los = [s[1].start or 0 for s in idx.values()]
            his = [s[1].stop if s[1].stop is not None else self.NB
                   for s in idx.values()]
            self._blk_lo, self._blk_hi = min(los), max(his)

    # -- helpers ----------------------------------------------------------
    def _put_chunk(self, chunk_np: np.ndarray):
        """[NB, n] uint8 (this process's slice in multi-host) → global
        [1, NB, n] array sharded over time."""
        if self.n_proc > 1:
            from ..parallel.distributed import host_chunk
            return host_chunk(self.mesh, chunk_np[None], self._raw_spec)
        return self._jax.device_put(chunk_np[None], self._raw_sh)

    def _put_rep(self, arr_np: np.ndarray, sharding):
        if self.n_proc > 1:
            from ..parallel.distributed import replicated_chunk
            return replicated_chunk(self.mesh, arr_np, sharding.spec)
        return self._jax.device_put(arr_np, sharding)

    def _step(self, off_g, chunk_np: np.ndarray,
              next_blk: np.ndarray | None):
        raw_g = self._put_chunk(chunk_np)
        if self.continuous:
            nb = next_blk if next_blk is not None else np.zeros(
                (1, self.block_bytes), dtype=np.uint8)
            nb_g = self._put_rep(np.ascontiguousarray(nb), self._rep_sh)
            hn = np.asarray([1.0 if next_blk is not None else 0.0],
                            dtype=self.cfg.np_dtype())
            hn_g = self._put_rep(hn, self._hn_sh)
            return self.sp.step_continuous(off_g, raw_g, nb_g, hn_g)
        return self.sp(off_g, raw_g)

    def run(self, fin: BinaryIO, fout: BinaryIO | None,
            tail_policy: str | None = None, metrics=None,
            checkpoint_path: str | None = None,
            checkpoint_every: int = 64, resume: bool = False) -> int:
        """Process the stream; returns blocks emitted (globally).

        ``fout`` may be None on non-writing processes (multi-host).
        Checkpoints store the carry state + byte offset after whole chunks
        (and after each tail block); resume seeks ``fin``.
        """
        import jax
        if tail_policy is None:
            tail_policy = "drop" if self.cfg.profile == "compat" else "pad"
        out_dtype = self.cfg.np_dtype()
        blocks = 0
        byte_offset = 0
        ck_every_chunks = max(1, int(checkpoint_every) // self.NB)
        from ..models.nbfm import PipelineState
        state0 = self.sp.pipe.init_state(batch_shape=(1,))
        if resume:
            if not checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            from .checkpoint import load_checkpoint
            state0, byte_offset, blocks = load_checkpoint(
                checkpoint_path, state0, cfg=self.cfg)
        off_np = np.asarray(state0.iq_off, dtype=out_dtype)
        if self.n_proc > 1:
            return self._run_multihost(fin, fout, off_np, blocks,
                                       byte_offset, tail_policy, metrics,
                                       checkpoint_path, ck_every_chunks)
        if byte_offset:
            fin.seek(byte_offset)
        reader = ChunkReader(fin, self.block_bytes, self.NB,
                             tail_policy=tail_policy)
        off_g = jax.device_put(off_np, self._off_sh)
        done_chunks = 0
        pending: list = []  # (audio_global, n_blocks, off_host_future)

        def ckpt(n_blocks_done, off_host):
            if checkpoint_path:
                from .checkpoint import save_checkpoint
                save_checkpoint(
                    checkpoint_path, PipelineState(iq_off=off_host),
                    byte_offset=byte_offset
                    + n_blocks_done * self.block_bytes,
                    blocks=blocks, cfg=self.cfg)

        def drain_one():
            nonlocal blocks, done_chunks
            audio, nb, off_h = pending.pop(0)
            fout.write(np.asarray(audio, dtype=out_dtype).tobytes())
            blocks += nb
            done_chunks += 1
            if metrics is not None:
                for _ in range(nb):
                    metrics.block_done()
            if checkpoint_path and done_chunks % ck_every_chunks == 0:
                ckpt(done_chunks * self.NB, np.asarray(off_h))

        cur: np.ndarray | None = None
        tail_blocks: np.ndarray | None = None
        for nxt in reader:
            if len(nxt) < self.NB:
                tail_blocks = nxt
                break
            if cur is not None:
                off_g, audio = self._step(off_g, cur, nxt[:1])
                pending.append((audio, self.NB, off_g))
                if len(pending) >= self.inflight:
                    drain_one()
            cur = nxt
        if cur is not None:
            first_tail = tail_blocks[:1] if tail_blocks is not None else None
            off_g, audio = self._step(off_g, cur, first_tail)
            pending.append((audio, self.NB, off_g))
        while pending:
            drain_one()
        n_done = done_chunks * self.NB
        if tail_blocks is not None:
            n_done, blocks = self._run_tail(
                tail_blocks, np.asarray(off_g), fout, out_dtype, n_done,
                blocks, metrics, ckpt)
        elif checkpoint_path:
            ckpt(n_done, np.asarray(off_g))
        if fout is not None:
            fout.flush()
        return blocks

    def _run_tail(self, tail_blocks, off_np, fout, out_dtype, n_done,
                  blocks, metrics, ckpt):
        """Per-block fallback for the last <NB blocks, carrying the chunk
        state (continuous: stationary filters with pairwise lookahead)."""
        import jax
        import jax.numpy as jnp
        from ..models.nbfm import PipelineState
        pipe = self.sp.pipe
        st = PipelineState(iq_off=jnp.asarray(off_np))
        nt = len(tail_blocks)
        if not self.continuous:
            fn = jax.jit(pipe.__call__)
            for blk in tail_blocks:
                st, out = fn(st, blk[None])
                fout.write(np.asarray(out, dtype=out_dtype).tobytes())
                blocks += 1
                n_done += 1
                if metrics is not None:
                    metrics.block_done()
                ckpt(n_done, np.asarray(st.iq_off))
            return n_done, blocks
        cond_fn = jax.jit(pipe.condition_block)
        post_fn = jax.jit(pipe.continuous_post)
        conds, states = [], []
        for blk in tail_blocks:
            st, cond = cond_fn(st, blk[None])
            conds.append(cond)
            states.append(st)   # state after conditioning blocks ..k
        zero_halo = np.zeros((1, 2 * pipe.halo_pairs), dtype=out_dtype)
        for k, cond in enumerate(conds):
            halo = (pipe.continuous_halo(conds[k + 1]) if k + 1 < nt
                    else zero_halo)
            out = post_fn(cond, halo)
            fout.write(np.asarray(out, dtype=out_dtype).tobytes())
            blocks += 1
            n_done += 1
            if metrics is not None:
                metrics.block_done()
            # resume re-conditions from block k+1 → state after blocks ..k
            ckpt(n_done, np.asarray(states[k].iq_off))
        return n_done, blocks

    def _run_multihost(self, fin, fout, off_np, blocks, byte_offset,
                       tail_policy, metrics, checkpoint_path,
                       ck_every_chunks):
        """Every process reads only its own block ranges (per-process pread).

        The chunk schedule is derived from the file size so all processes
        agree on the collective sequence without coordination.

        The step loop keeps the same ``inflight`` window as the single-host
        path: reads for chunk c+1 overlap device compute of chunk c (the
        reference's producer thread scaled out, src/main.c:58-98).  Output:
        by default the audio is replicated with ONE async-dispatched
        all_gather and process 0 writes; with ``shared_output=True`` the
        gather disappears entirely — every process pwrites its own time
        shards into the (shared-filesystem) output file at their exact
        byte offsets, so output network traffic is zero instead of N× the
        audio."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..models.nbfm import PipelineState
        out_dtype = self.cfg.np_dtype()
        bb = self.block_bytes
        out_blk = (bb // 4) * np.dtype(out_dtype).itemsize
        fd = fin.fileno()
        total_bytes = os.fstat(fd).st_size
        avail = max(0, total_bytes - byte_offset)
        n_blocks_total = avail // bb
        n_chunks = n_blocks_total // self.NB
        tail_n = n_blocks_total - n_chunks * self.NB

        def read_blocks(block_idx: int, count: int) -> np.ndarray:
            buf = np.empty((count, bb), dtype=np.uint8)
            view = memoryview(buf).cast("B")
            pos = byte_offset + block_idx * bb
            need = count * bb
            got = 0
            while got < need:
                r = os.pread(fd, need - got, pos + got)
                if not r:
                    raise IOError("short read in multihost ingest")
                view[got: got + len(r)] = r
                got += len(r)
            return buf

        off_g = self._put_rep(off_np, self._off_sh)
        writer = fout if jax.process_index() == 0 else None
        done_chunks = 0
        shared = self.shared_output and fout is not None
        out_base = fout.tell() if shared else 0
        rep = jax.jit(
            lambda x: x,
            out_shardings=NamedSharding(self.mesh, P(None, None, None)))

        def ckpt(n_blocks_done, off_host):
            if checkpoint_path and jax.process_index() == 0:
                from .checkpoint import save_checkpoint
                save_checkpoint(
                    checkpoint_path, PipelineState(iq_off=off_host),
                    byte_offset=byte_offset + n_blocks_done * bb,
                    blocks=blocks, cfg=self.cfg)

        pending: list = []  # (chunk_idx, audio handle, off handle)

        def drain_one():
            nonlocal blocks, done_chunks
            c, audio, off_h = pending.pop(0)
            if self.shared_output:
                if fout is not None:
                    ofd = fout.fileno()
                    for shard in audio.addressable_shards:
                        sl = shard.index[1]
                        start = sl.start or 0
                        data = np.asarray(shard.data, dtype=out_dtype)
                        os.pwrite(ofd, data.tobytes(),
                                  out_base + (c * self.NB + start) * out_blk)
            elif writer is not None:
                writer.write(np.asarray(audio.addressable_data(0),
                                        dtype=out_dtype).tobytes())
            blocks += self.NB
            done_chunks += 1
            if metrics is not None and jax.process_index() == 0:
                for _ in range(self.NB):
                    metrics.block_done()
            if done_chunks % ck_every_chunks == 0:
                ckpt(done_chunks * self.NB, np.asarray(off_h))

        for c in range(n_chunks):
            local = read_blocks(c * self.NB + self._blk_lo,
                                self._blk_hi - self._blk_lo)
            nxt_idx = (c + 1) * self.NB
            next_blk = (read_blocks(nxt_idx, 1)
                        if self.continuous and nxt_idx < n_blocks_total
                        else None)
            off_g, audio = self._step(off_g, local, next_blk)
            # async: the gather (a collective — every process dispatches it;
            # none at all in shared mode) is dispatched now and materialized
            # at drain time, so it overlaps the next chunk's pread + step
            pending.append((c, audio if self.shared_output else rep(audio),
                            off_g))
            if len(pending) >= self.inflight:
                drain_one()
        while pending:
            drain_one()
        n_done = done_chunks * self.NB
        if shared and writer is not None:
            # position p0's stream cursor after the pwritten region so the
            # tail path can append sequentially
            fout.seek(out_base + n_done * out_blk)
        part = avail - n_blocks_total * bb
        n_tail = tail_n + (1 if tail_policy == "pad" and part else 0)
        if n_tail and writer is not None:
            tail = (read_blocks(n_chunks * self.NB, tail_n) if tail_n
                    else np.empty((0, bb), dtype=np.uint8))
            if n_tail > tail_n:  # pad: overlay partial bytes on prev block
                prev = (tail[-1] if tail_n
                        else read_blocks(n_blocks_total - 1, 1)[0]
                        if n_blocks_total else np.zeros(bb, np.uint8))
                pad = prev.copy()
                extra = os.pread(fd, part, byte_offset + n_blocks_total * bb)
                pad[: len(extra)] = np.frombuffer(extra, np.uint8)
                tail = np.concatenate([tail, pad[None]])
            n_done, blocks = self._run_tail(tail, np.asarray(off_g), writer,
                                            out_dtype, n_done, blocks,
                                            metrics, ckpt)
        elif n_tail:
            blocks += n_tail  # counted globally; only p0 processes/writes
        elif checkpoint_path:
            ckpt(n_done, np.asarray(off_g))
        if writer is not None:
            writer.flush()
        return blocks


class StreamProcessor:
    """Connects a BlockReader to the jitted pipeline and an output file.

    ``inflight`` bounds the number of dispatched-but-unread device results,
    overlapping host IO with device compute (the reference's 2-thread
    pipeline, without locks).
    """

    def __init__(self, cfg: DemodConfig, fast_atan2: bool = False,
                 inflight: int = 2, pipeline=None, use_native: bool = True,
                 chunk_blocks: int = 16, aot: bool = False):
        """``pipeline`` overrides the NBFM BlockPipeline with any per-block
        model exposing init_state() / __call__(state, raw) / block_bytes
        (e.g. models.wbfm.WbfmPipeline).

        ``chunk_blocks``: NB blocks dispatched per device call on the NBFM
        paths (1 = per-block).  Per-block dispatch pays the host's Python
        and dispatch cost once per 256 KiB block; chunking amortizes it
        exactly like ShardedStreamProcessor: blocks are state-free in the
        compat profile (SURVEY.md §1 fact 3), so those paths are
        byte-identical to per-block; q1's DC tracker chains over the batch
        axis via the associative block prefix
        (BlockPipeline.process_blocks), which agrees with per-block to fp
        tolerance (~1e-7 rel — the recurrence is contracting), not bytes.

        ``aot``: warm-start via the serialized-executable cache
        (runtime/aot.py) — the chunk-shaped jit is AOT-compiled in
        __init__ and the pickled executable reused by later processes,
        skipping trace and lowering; shapes other than the full chunk
        (stream tails) fall back to the plain jit."""
        import jax
        self.cfg = cfg
        self._continuous = False
        self.chunk_blocks = 1
        self.aot_hit = None   # True/False once aot was attempted
        if pipeline is None:
            self.pipe = BlockPipeline(cfg, fast_atan2=fast_atan2)
            self.block_bytes = cfg.buf_size
            if cfg.profile == "continuous":
                # carry-state continuous filtering: conditioning stays
                # per-block, the filters run stationary with a one-block
                # lookahead halo (BlockPipeline.continuous_post)
                self._continuous = True
                self._cond_fn = jax.jit(self.pipe.condition_block,
                                        donate_argnums=(0,))
                self._post_fn = jax.jit(self.pipe.continuous_post)
                self._halo_reals = 2 * self.pipe.halo_pairs
                self.fn = None
                self.inflight = max(1, inflight)
                self.use_native = use_native
                return
            # process_blocks chains the q1 tracker over the block axis
            # (blocked affine prefix) and is the plain batched __call__
            # everywhere else
            inner = self.pipe.process_blocks
            self.chunk_blocks = NB = max(1, chunk_blocks)
            jfn = jax.jit(inner, donate_argnums=(0,))
            comp = None
            if aot:
                comp = self._aot_compile(inner, NB, fast_atan2)

            def fn(st, raw, _jfn=jfn, _comp=comp, _nb=NB):
                x = raw if raw.ndim == 2 else raw[None]
                if _comp is not None and x.shape[0] == _nb:
                    return _comp(st, x)
                return _jfn(st, x)

            self.fn = fn
        else:
            self.pipe = pipeline
            self.block_bytes = pipeline.block_bytes
            if hasattr(pipeline, "call_u16"):
                # host-viewed uint16 (one complex sample per element):
                # skips the device-side byte-pair pack (WBFM)
                f16 = jax.jit(pipeline.call_u16)
                comp = None
                if aot:
                    import time as _time
                    from .aot import cached_pipeline_jit
                    t0 = _time.perf_counter()
                    T = self.block_bytes // 2
                    comp, loaded = cached_pipeline_jit(
                        pipeline.call_u16,
                        getattr(pipeline, "cfg", cfg),
                        (jax.eval_shape(pipeline.init_state),
                         jax.ShapeDtypeStruct((T,), np.uint16)),
                        f"{type(pipeline).__name__}.call_u16")
                    self.aot_s = _time.perf_counter() - t0
                    self.aot_hit = loaded

                def fn16(st, raw, _f=f16, _c=comp,
                         _T=self.block_bytes // 2):
                    u = np.ascontiguousarray(raw).view(np.uint16)
                    if _c is not None and u.shape == (_T,):
                        return _c(st, u)
                    return _f(st, u)

                self.fn = fn16
            else:
                self.fn = jax.jit(pipeline.__call__)
        self.inflight = max(1, inflight)
        self.use_native = use_native

    def _aot_compile(self, inner, NB: int, fast_atan2: bool):
        """AOT-compile ``inner`` at the chunk shape through the
        serialized-executable cache (runtime/aot.py).  Records aot_hit and
        aot_s for the CLI's phase instrumentation."""
        import time as _time
        import jax
        from .aot import cached_compile, aot_cache_dir
        from .checkpoint import config_fingerprint
        from .. import __version__
        if aot_cache_dir() is None:
            return None
        t0 = _time.perf_counter()
        cfg = self.cfg
        st_struct = jax.eval_shape(self.pipe.init_state)
        x_struct = jax.ShapeDtypeStruct((NB, cfg.buf_size), np.uint8)
        key = {"cfg": config_fingerprint(cfg), "variant": "xla_blocks",
               "fast_atan2": bool(fast_atan2), "pkg": __version__}
        comp, loaded = cached_compile(inner, (st_struct, x_struct), key,
                                      donate_argnums=(0,))
        self.aot_s = _time.perf_counter() - t0
        self.aot_hit = loaded
        return comp

    def _make_reader(self, fin: BinaryIO, tail_policy: str,
                     offset: int = 0):
        return make_reader(fin, self.block_bytes, tail_policy,
                           offset=offset, use_native=self.use_native)

    def run(self, fin: BinaryIO, fout: BinaryIO,
            tail_policy: str | None = None,
            checkpoint_path: str | None = None,
            checkpoint_every: int = 64,
            resume: bool = False,
            metrics=None) -> int:
        """Process the stream; returns number of blocks emitted.

        checkpoint_path/resume: save carry state + byte offset every
        ``checkpoint_every`` blocks (and at EOF); resuming seeks ``fin``
        to the saved offset (requires a seekable input) and restores state.
        metrics: optional utils.metrics.StreamMetrics.
        """
        if tail_policy is None:
            tail_policy = "drop" if self.cfg.profile == "compat" else "pad"
        state = self.pipe.init_state()
        blocks = 0
        byte_offset = 0
        checkpoint_every = max(1, int(checkpoint_every))
        # fingerprint the config that actually built the graph: a pipeline
        # override (WBFM, channel bank) carries its own dataclass
        ck_cfg = getattr(self.pipe, "cfg", self.cfg)
        if resume:
            if not checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            from .checkpoint import load_checkpoint
            state, byte_offset, blocks = load_checkpoint(
                checkpoint_path, state, cfg=ck_cfg)
        if self.chunk_blocks > 1 and not self._continuous:
            return self._run_chunked(fin, fout, tail_policy, state, blocks,
                                     byte_offset, checkpoint_path,
                                     checkpoint_every, ck_cfg, metrics)
        # offset is handled inside the reader: lseek/skip-read for the
        # native one, seek-or-skip of fin for the Python fallback — so a
        # pipe capture (stdin/FIFO) is resumable too
        reader = self._make_reader(fin, tail_policy, offset=byte_offset)
        if self._continuous:
            return self._run_continuous(reader, fout, state, blocks,
                                        byte_offset, checkpoint_path,
                                        checkpoint_every, ck_cfg, metrics)
        import time as _time
        t_run0 = _time.perf_counter()
        self.first_output_s = None
        pending: list = []
        out_dtype = self.cfg.np_dtype()

        def ckpt():
            if checkpoint_path:
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, state_done,
                                byte_offset=byte_offset + done * self.block_bytes,
                                blocks=blocks, cfg=ck_cfg)

        done = 0            # blocks fully written since (re)start
        state_done = state  # carry state as of `done` blocks
        state_q: list = []  # device-copy snapshots at checkpoint boundaries
        snap_fn = None
        if checkpoint_path:
            # Checkpointing must not serialize the pipeline: snapshotting
            # via np.asarray at dispatch time forces a per-block device
            # sync that defeats the inflight window.  Instead, dispatch an
            # ASYNC on-device copy of the state (before the next fn call
            # consumes the donated buffer) only for blocks that will land
            # on a checkpoint boundary, and materialize at drain time —
            # when the paired audio write syncs that dispatch anyway.
            import jax as _jax
            import jax.numpy as _jnp
            snap_fn = _jax.jit(lambda s: _jax.tree.map(_jnp.copy, s))
        dispatched = 0
        for raw in reader:
            state, out = self.fn(state, raw)
            dispatched += 1
            pending.append(out)
            if snap_fn is not None and dispatched % checkpoint_every == 0:
                state_q.append(snap_fn(state))
            else:
                state_q.append(None)
            if len(pending) >= self.inflight:
                fout.write(np.asarray(pending.pop(0),
                                      dtype=out_dtype).tobytes())
                if self.first_output_s is None:
                    self.first_output_s = _time.perf_counter() - t_run0
                snap = state_q.pop(0)
                blocks += 1
                done += 1
                if metrics is not None:
                    metrics.block_done()
                if snap is not None:
                    import jax as _jax
                    state_done = _jax.tree.map(np.asarray, snap)
                    ckpt()
        for out in pending:
            fout.write(np.asarray(out, dtype=out_dtype).tobytes())
            snap = state_q.pop(0)
            blocks += 1
            done += 1
            if metrics is not None:
                metrics.block_done()
            if snap is not None and checkpoint_path:
                import jax as _jax
                state_done = _jax.tree.map(np.asarray, snap)
                if done % checkpoint_every == 0:
                    ckpt()
        fout.flush()
        if checkpoint_path:
            # final state: `state` (after all blocks) is still live — the
            # stream is over, so this single sync is free
            import jax as _jax
            state_done = _jax.tree.map(np.asarray, state)
            ckpt()
        return blocks

    def _run_chunked(self, fin, fout, tail_policy, state, blocks,
                     byte_offset, checkpoint_path, checkpoint_every,
                     ck_cfg, metrics) -> int:
        """NB-blocks-per-dispatch streaming (the default on the NBFM
        paths): a background ChunkReader prefetches [NB, bb] chunks read
        with one readinto each, the jitted fn processes all NB blocks in
        one device call (byte-identical to per-block on the state-free
        compat paths; q1's tracker chains over the batch axis via the
        associative block prefix — fp-tolerance equal), and an
        ``inflight`` window of dispatched chunks overlaps host IO with
        device compute.  The stream tail (< NB whole blocks) falls back to
        per-block dispatch carrying the same state.  Replaces the
        reference's 2-thread overlap (src/main.c:58-98) with ~NB× less
        per-block dispatch overhead."""
        import time as _time
        import jax
        import jax.numpy as jnp
        NB = self.chunk_blocks
        out_dtype = self.cfg.np_dtype()
        t_run0 = _time.perf_counter()
        self.first_output_s = None  # time to first written chunk: captures
        # trace+compile+first dispatch, apart from steady-state throughput
        self.first_dispatch_s = None  # first fn() return: trace+compile
        # (or AOT load already done in __init__) without the data movement
        if byte_offset:
            _seek_or_skip(fin, byte_offset)
        reader = ChunkReader(fin, self.block_bytes, NB,
                             tail_policy=tail_policy)
        ck_every_chunks = max(1, checkpoint_every // NB)
        snap_fn = (jax.jit(lambda s: jax.tree.map(jnp.copy, s))
                   if checkpoint_path else None)
        pending: list = []   # (audio, n_blocks, state_snapshot_or_None)
        done = 0             # blocks written since (re)start
        done_chunks = 0

        def ckpt(state_h):
            if checkpoint_path:
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path,
                                jax.tree.map(np.asarray, state_h),
                                byte_offset=byte_offset
                                + done * self.block_bytes,
                                blocks=blocks, cfg=ck_cfg)

        def drain_one():
            nonlocal blocks, done, done_chunks
            audio, nb, snap = pending.pop(0)
            fout.write(np.asarray(audio, dtype=out_dtype).tobytes())
            if self.first_output_s is None:
                self.first_output_s = _time.perf_counter() - t_run0
            blocks += nb
            done += nb
            done_chunks += 1
            if metrics is not None:
                for _ in range(nb):
                    metrics.block_done()
            if snap is not None:
                ckpt(snap)

        tail_chunk: np.ndarray | None = None
        dispatched_chunks = 0
        for chunk in reader:
            if len(chunk) < NB:
                tail_chunk = chunk
                break
            state, audio = self.fn(state, chunk)
            if self.first_dispatch_s is None:
                self.first_dispatch_s = _time.perf_counter() - t_run0
            dispatched_chunks += 1
            snap = (snap_fn(state) if snap_fn is not None
                    and dispatched_chunks % ck_every_chunks == 0 else None)
            pending.append((audio, NB, snap))
            if len(pending) >= self.inflight:
                drain_one()
        while pending:
            drain_one()
        if tail_chunk is not None:
            # per-block fallback: reuses the B=1 jit specialization so any
            # tail length shares one compile
            for blk in tail_chunk:
                state, out = self.fn(state, blk)
                fout.write(np.asarray(out, dtype=out_dtype).tobytes())
                blocks += 1
                done += 1
                if metrics is not None:
                    metrics.block_done()
        fout.flush()
        if checkpoint_path:
            ckpt(state)
        return blocks

    def _run_continuous(self, reader, fout, state, blocks, byte_offset,
                        checkpoint_path, checkpoint_every, ck_cfg, metrics):
        """Continuous-profile streaming: condition each block on arrival,
        filter the PREVIOUS block with the new block's conditioned head as
        its stationary halo (zero halo at EOF).  Output sample i of block k
        equals the infinite-stream stationary response — no per-block
        transients.  jit dispatch is async, so conditioning block k+1
        overlaps the device filtering of block k."""
        import jax
        from jax.numpy import copy as jnp_copy
        out_dtype = self.cfg.np_dtype()
        done = 0
        cond_prev = None

        def ckpt(n_done, st):
            if checkpoint_path and st is not None:
                from .checkpoint import save_checkpoint
                # st may hold device arrays (async snapshot): save_checkpoint
                # materializes leaves itself, so the sync lands here — at a
                # checkpoint boundary — not once per block
                save_checkpoint(checkpoint_path, st,
                                byte_offset=byte_offset
                                + n_done * self.block_bytes,
                                blocks=blocks, cfg=ck_cfg)

        # resume semantics: a checkpoint at `done` blocks written holds the
        # conditioning state after blocks 0..done-1, so the resumed run
        # re-conditions block `done` (the previous run's halo block) itself.
        # Snapshots are ASYNC on-device copies (dispatched before the next
        # _cond_fn call consumes the donated state buffer); they only
        # materialize inside ckpt(), so checkpointing never serializes the
        # conditioning↔filtering overlap.
        snap_fn = (jax.jit(lambda s: jax.tree.map(jnp_copy, s))
                   if checkpoint_path else None)
        state_h = snap_fn(state) if checkpoint_path else None
        for raw in reader:
            # state_h currently = state after the blocks already WRITTEN
            new_state, cond = self._cond_fn(state, raw)
            if cond_prev is not None:
                out = self._post_fn(cond_prev,
                                    self.pipe.continuous_halo(cond))
                fout.write(np.asarray(out, dtype=out_dtype).tobytes())
                blocks += 1
                done += 1
                if metrics is not None:
                    metrics.block_done()
                if checkpoint_path and done % checkpoint_every == 0:
                    ckpt(done, state_h)
            cond_prev = cond
            state = new_state
            if checkpoint_path:
                state_h = snap_fn(state)
        if cond_prev is not None:
            halo = np.zeros((*cond_prev.shape[:-1], self._halo_reals),
                            dtype=out_dtype)
            out = self._post_fn(cond_prev, halo)
            fout.write(np.asarray(out, dtype=out_dtype).tobytes())
            blocks += 1
            done += 1
            if metrics is not None:
                metrics.block_done()
        fout.flush()
        ckpt(done, state_h)
        return blocks
