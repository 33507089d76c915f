"""Multi-process (multi-host analog) tests: two OS processes, each with two
virtual CPU devices, coordinate through jax.distributed into ONE global
4-device mesh and run the sharded pipeline — the framework's multi-host story
exercised for real, not simulated (SURVEY.md §2.10 / §5 "distributed
communication backend").

Each worker checks its own addressable output shards against the
single-process golden pipeline on identical input; the test asserts both
workers succeed.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port, pid = sys.argv[1], int(sys.argv[2])

    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from demodulator_tpu.parallel.distributed import (
        init_distributed, host_chunk, replicated_chunk)
    from demodulator_tpu.parallel.mesh import make_demod_mesh
    from demodulator_tpu.parallel.sharding import ShardedPipeline
    from demodulator_tpu.models.nbfm import BlockPipeline
    from demodulator_tpu.config import DemodConfig

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()

    mesh = make_demod_mesh(n_time=4, n_chan=1)
    C, NB, n = 2, 8, 512
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, size=(C, NB, n), dtype=np.uint8)

    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      buf_size=n, num_channels=C)
    cfg.mode |= 1 << 2                     # -q1 correctIq: cross-shard comm
    sp = ShardedPipeline(cfg, mesh)

    off0_np = np.zeros((C, 2), dtype=np.float32)
    # time axis is sharded: this host owns blocks [pid*4, pid*4+4)
    lo, hi = pid * 4, pid * 4 + 4
    raw_g = host_chunk(mesh, raw[:, lo:hi], P(None, "time", None))
    off_g = replicated_chunk(mesh, off0_np, P(None, None))

    new_off, audio = sp(off_g, raw_g)
    jax.block_until_ready(audio)

    # golden: the sequential single-process pipeline on the full input
    pipe = BlockPipeline(cfg)
    st = pipe.init_state(batch_shape=(C,))
    ref_blocks = []
    for b in range(NB):
        st, out = pipe(st, raw[:, b])
        ref_blocks.append(np.asarray(out))
    ref = np.stack(ref_blocks, axis=1)     # [C, NB, n/4]
    ref_off = np.asarray(st.iq_off)

    for shard in audio.addressable_shards:
        want = ref[shard.index]
        np.testing.assert_allclose(np.asarray(shard.data), want,
                                   rtol=0, atol=2e-4)
    for shard in new_off.addressable_shards:
        np.testing.assert_allclose(np.asarray(shard.data),
                                   ref_off[shard.index], rtol=1e-4,
                                   atol=1e-5)
    print("OK", pid)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("profile_args", [[], ["--profile", "continuous"]])
def test_two_process_cli_shard_time(tmp_path, profile_args):
    """End-to-end multi-host CLI ingest (VERDICT missing #2): two processes
    × two virtual devices, --distributed --shard-time 4.  Each process
    reads only its own block ranges of the input file; process 0's output
    must be byte-identical to the single-process run."""
    import numpy as np
    import pathlib
    import shutil
    import tempfile
    port = _free_port()
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, 11 * 4096, dtype=np.uint8).tobytes()
    # paths must not contain '-' (the CLI reproduces the reference's strstr
    # stdin/stdout quirk); pytest tmp dirs do
    tmp_path = pathlib.Path(tempfile.mkdtemp(prefix="distcli", dir="/tmp"))
    src = tmp_path / "iq.dat"
    src.write_bytes(data)
    args = ["-S", "192000", "-l", "12500", "-b", "-6", "-q", "1",
            "--shard-time", "4", *profile_args]

    env1 = {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env1.update(JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    single = tmp_path / "single.raw"
    r = subprocess.run([sys.executable, "-m", "demodulator_tpu",
                        "-i", str(src), "-o", str(single), *args],
                       capture_output=True, env=env1, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()

    procs = []
    outs = [tmp_path / f"dist{p}.raw" for p in (0, 1)]
    for p in (0, 1):
        env = dict(env1)
        env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   DEMODULATOR_TPU_COORDINATOR=f"localhost:{port}",
                   DEMODULATOR_TPU_NUM_PROCESSES="2",
                   DEMODULATOR_TPU_PROCESS_ID=str(p))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "demodulator_tpu", "-i", str(src),
             "-o", str(outs[p]), "--distributed", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    for p, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed CLI worker timed out")
        assert proc.returncode == 0, f"worker {p}:\n{err.decode()[-3000:]}"
    assert outs[0].read_bytes() == single.read_bytes()
    assert outs[1].read_bytes() == b""  # non-zero processes write nothing
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_two_process_global_mesh(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert "OK" in out


def test_two_process_cli_shared_out(tmp_path):
    """--shared-out: both processes pwrite their OWN time shards into one
    shared output file (zero output network traffic — no gather at all);
    result must be byte-identical to the single-process run."""
    import numpy as np
    import pathlib
    import shutil
    import tempfile
    port = _free_port()
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, 19 * 4096, dtype=np.uint8).tobytes()
    tmp_path = pathlib.Path(tempfile.mkdtemp(prefix="distshared", dir="/tmp"))
    src = tmp_path / "iq.dat"
    src.write_bytes(data)
    args = ["-S", "192000", "-l", "12500", "-b", "-6",
            "--shard-time", "4"]

    env1 = {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env1.update(JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    single = tmp_path / "single.raw"
    r = subprocess.run([sys.executable, "-m", "demodulator_tpu",
                        "-i", str(src), "-o", str(single), *args],
                       capture_output=True, env=env1, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()

    shared = tmp_path / "shared.raw"
    procs = []
    for p in (0, 1):
        env = dict(env1)
        env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   DEMODULATOR_TPU_COORDINATOR=f"localhost:{port}",
                   DEMODULATOR_TPU_NUM_PROCESSES="2",
                   DEMODULATOR_TPU_PROCESS_ID=str(p))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "demodulator_tpu", "-i", str(src),
             "-o", str(shared), "--distributed", "--shared-out", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    for p, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed CLI worker timed out")
        assert proc.returncode == 0, f"worker {p}:\n{err.decode()[-3000:]}"
    assert shared.read_bytes() == single.read_bytes()
    shutil.rmtree(tmp_path, ignore_errors=True)
