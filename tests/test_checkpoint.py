"""Checkpoint/resume: interrupted stream == uninterrupted stream."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from demodulator_tpu.config import DemodConfig
from demodulator_tpu.runtime.checkpoint import (CheckpointError,
                                                load_checkpoint,
                                                save_checkpoint)
from demodulator_tpu.runtime.stream import StreamProcessor

BUF = 4096


def _cfg(**kw):
    base = dict(sample_rate=192000.0, lowpass_out=12500.0, buf_size=BUF,
                mode=0x10 | (1 << 2))  # correctIq: real carry state
    base.update(kw)
    return DemodConfig(**base)


def _data(nblocks, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, nblocks * BUF, dtype=np.uint8).tobytes()


def test_roundtrip_and_fingerprint(tmp_path):
    cfg = _cfg()
    proc = StreamProcessor(cfg)
    st = proc.pipe.init_state()
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, st, byte_offset=123 * BUF, blocks=123, cfg=cfg)
    st2, off, blocks = load_checkpoint(p, proc.pipe.init_state(), cfg=cfg)
    assert off == 123 * BUF and blocks == 123
    np.testing.assert_array_equal(np.asarray(st.iq_off), np.asarray(st2.iq_off))
    # different config → refused
    with pytest.raises(CheckpointError):
        load_checkpoint(p, proc.pipe.init_state(), cfg=_cfg(lowpass_out=6500.0))


def test_resume_equals_uninterrupted(tmp_path):
    """Run 6 blocks straight vs 3 blocks + checkpoint + resume for 3 more.
    correctIq's DC tracker state must carry exactly."""
    cfg = _cfg()
    data = _data(6, seed=1)
    src = tmp_path / "iq.dat"
    src.write_bytes(data)
    ck = str(tmp_path / "ck.npz")

    out_full = io.BytesIO()
    with open(src, "rb") as f:
        StreamProcessor(cfg).run(f, out_full)

    # first half, checkpoint every block
    first = tmp_path / "first.dat"
    first.write_bytes(data[: 3 * BUF])
    out_a = io.BytesIO()
    with open(first, "rb") as f:
        StreamProcessor(cfg).run(f, out_a, checkpoint_path=ck,
                                 checkpoint_every=1)
    # resume against the full file
    out_b = io.BytesIO()
    with open(src, "rb") as f:
        StreamProcessor(cfg).run(f, out_b, checkpoint_path=ck, resume=True)

    joined = out_a.getvalue() + out_b.getvalue()
    assert joined == out_full.getvalue()
    assert len(joined) == 6 * BUF  # 6 blocks × BUF/4 f32 samples × 4 bytes


def test_resume_wbfm_state(tmp_path):
    """WBFM's overlap-save histories survive the checkpoint: resumed audio is
    continuous (equal to uninterrupted) through the block boundary."""
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    wcfg = WbfmConfig(block_seconds=0.01)
    cfg = _cfg()  # outer cfg only fingerprints the run; state is the pipe's
    pipe = WbfmPipeline(wcfg)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 4 * pipe.block_bytes, np.uint8).tobytes()
    src = tmp_path / "iq.dat"
    src.write_bytes(data)
    ck = str(tmp_path / "ck.npz")

    out_full = io.BytesIO()
    with open(src, "rb") as f:
        StreamProcessor(cfg, pipeline=WbfmPipeline(wcfg)).run(
            f, out_full, tail_policy="drop")

    half = tmp_path / "half.dat"
    half.write_bytes(data[: 2 * pipe.block_bytes])
    out_a = io.BytesIO()
    with open(half, "rb") as f:
        StreamProcessor(cfg, pipeline=WbfmPipeline(wcfg)).run(
            f, out_a, tail_policy="drop", checkpoint_path=ck,
            checkpoint_every=1)
    out_b = io.BytesIO()
    with open(src, "rb") as f:
        StreamProcessor(cfg, pipeline=WbfmPipeline(wcfg)).run(
            f, out_b, tail_policy="drop", checkpoint_path=ck, resume=True)
    assert out_a.getvalue() + out_b.getvalue() == out_full.getvalue()


def test_cli_checkpoint_shard_time(tmp_path):
    """--checkpoint + --shard-time (previously refused): interrupt after
    one full chunk, resume — joined output equals the uninterrupted run,
    including the correctIq carry into the sub-chunk tail."""
    import shutil
    import tempfile
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    repo = os.path.dirname(os.path.dirname(__file__))
    tmp = __import__("pathlib").Path(tempfile.mkdtemp(prefix="cksh",
                                                      dir="/tmp"))
    try:
        data = _data(11, seed=5)          # NB=8 chunk + 3-block tail
        src = tmp / "iq.dat"
        src.write_bytes(data)
        ck = tmp / "ck.npz"
        base = [sys.executable, "-m", "demodulator_tpu",
                "-S", "192000", "-l", "12500", "-b", "-6", "-q", "1",
                "--shard-time", "4"]
        full = tmp / "full.raw"
        r = subprocess.run(base + ["-i", str(src), "-o", str(full)],
                           capture_output=True, env=env, cwd=repo)
        assert r.returncode == 0, r.stderr.decode()

        half = tmp / "half.dat"
        half.write_bytes(data[: 8 * BUF])  # exactly one chunk
        a = tmp / "a.raw"
        r = subprocess.run(base + ["-i", str(half), "-o", str(a),
                                   "--checkpoint", str(ck),
                                   "--checkpoint-every", "1"],
                           capture_output=True, env=env, cwd=repo)
        assert r.returncode == 0, r.stderr.decode()
        b = tmp / "b.raw"
        r = subprocess.run(base + ["-i", str(src), "-o", str(b),
                                   "--checkpoint", str(ck), "--resume"],
                           capture_output=True, env=env, cwd=repo)
        assert r.returncode == 0, r.stderr.decode()
        assert a.read_bytes() + b.read_bytes() == full.read_bytes()
        assert len(a.read_bytes()) == 8 * BUF
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_cli_checkpoint_flags(tmp_path):
    """--checkpoint/--resume through the real CLI.  NOTE: paths must not
    contain '-' — the CLI faithfully reproduces the reference's strstr
    stdin/stdout quirk (src/main.c:127-142), and pytest's tmp dirs contain
    dashes."""
    import shutil
    import tempfile
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    repo = os.path.dirname(os.path.dirname(__file__))
    tmp_path = __import__("pathlib").Path(tempfile.mkdtemp(prefix="ckcli",
                                                           dir="/tmp"))
    data = _data(4, seed=3)
    src = tmp_path / "iq.dat"
    src.write_bytes(data)
    ck = tmp_path / "ck.npz"
    base = [sys.executable, "-m", "demodulator_tpu",
            "-S", "192000", "-l", "12500", "-b", "-6", "-q", "1"]

    full = tmp_path / "full.raw"
    r = subprocess.run(base + ["-i", str(src), "-o", str(full)],
                       capture_output=True, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr.decode()

    half = tmp_path / "half.dat"
    half.write_bytes(data[: 2 * BUF])
    a = tmp_path / "a.raw"
    r = subprocess.run(base + ["-i", str(half), "-o", str(a),
                               "--checkpoint", str(ck),
                               "--checkpoint-every", "1", "--metrics"],
                       capture_output=True, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr.decode()
    assert b"stream_done" in r.stderr  # --metrics emitted structured logs
    b = tmp_path / "b.raw"
    r = subprocess.run(base + ["-i", str(src), "-o", str(b),
                               "--checkpoint", str(ck), "--resume"],
                       capture_output=True, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr.decode()
    assert a.read_bytes() + b.read_bytes() == full.read_bytes()
    shutil.rmtree(tmp_path, ignore_errors=True)
