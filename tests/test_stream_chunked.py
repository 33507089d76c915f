"""Chunked streaming (NB blocks per dispatch) == per-block streaming.

The default StreamProcessor path dispatches chunk_blocks blocks per device
call (runtime/stream.py _run_chunked) to amortize per-dispatch overhead —
the reference's 2-thread overlap analog (src/main.c:58-98) at NB× lower
dispatch rate.  Blocks are state-free in the compat profile (SURVEY.md §1
fact 3) and -q1's DC tracker chains over the batch axis, so the output
must be BYTE-identical to per-block dispatch, including a stream tail
that is not a multiple of NB.
"""
import io
import os

import numpy as np
import pytest

from demodulator_tpu.config import config_from_cli_opts
from demodulator_tpu.runtime.stream import StreamProcessor


def _cfg(extra=None):
    opts = {"S": "96000", "l": "12500", "b": "-4"}  # small blocks: fast CPU
    if extra:
        opts.update(extra)
    cfg = config_from_cli_opts(opts)
    cfg.validate()
    return cfg


def _run(cfg, data, chunk_blocks, **kw):
    proc = StreamProcessor(cfg, use_native=False,
                           chunk_blocks=chunk_blocks)
    out = io.BytesIO()
    proc.run(io.BytesIO(data), out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("q", [None, "1", "3"])
@pytest.mark.parametrize("nblocks", [1, 4, 10])
def test_chunked_matches_per_block(q, nblocks):
    cfg = _cfg({"q": q} if q else None)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, nblocks * cfg.buf_size,
                        dtype=np.uint8).tobytes()
    a, b = _run(cfg, data, 4), _run(cfg, data, 1)
    if q == "1" and nblocks > 4:
        # q1 composes the affine DC-tracker prefix over the chunk's block
        # axis (BlockPipeline.process_blocks) — a different f32
        # association order than sequential per-block
        # updates, so cross-chunk state agrees to fp tolerance, not
        # bit-for-bit
        np.testing.assert_allclose(np.frombuffer(a, np.float32),
                                   np.frombuffer(b, np.float32),
                                   rtol=2e-5, atol=2e-5)
    else:
        assert a == b


def test_chunked_tail_policy_pad():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 5 * cfg.buf_size + 100,
                        dtype=np.uint8).tobytes()
    for policy in ("drop", "pad"):
        assert (_run(cfg, data, 4, tail_policy=policy)
                == _run(cfg, data, 1, tail_policy=policy)), policy


def test_chunked_checkpoint_resume(tmp_path):
    """Interrupt after the first chunks, resume, and match an
    uninterrupted chunked run (stateful -q1 so the carry matters)."""
    cfg = _cfg({"q": "1"})
    rng = np.random.default_rng(5)
    n = 9
    data = rng.integers(0, 256, n * cfg.buf_size, dtype=np.uint8).tobytes()
    ck = os.fspath(tmp_path / "ck.npz")
    whole = _run(cfg, data, 3)
    # first leg: only the first 6 blocks exist (2 chunks), checkpoint each
    first = _run(cfg, data[: 6 * cfg.buf_size], 3,
                 checkpoint_path=ck, checkpoint_every=3)
    # second leg resumes from the checkpoint and sees the full stream
    proc = StreamProcessor(cfg, use_native=False, chunk_blocks=3)
    out = io.BytesIO()
    proc.run(io.BytesIO(data), out, checkpoint_path=ck, resume=True)
    assert first + out.getvalue() == whole
