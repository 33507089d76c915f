"""Runtime-feature parity of the bank CLI families (VERDICT r4 item 5).

The reference funnels every mode through one consumer loop with uniform
behavior (src/matrix.c:178-280); the framework's equivalent contract is
that --bank and --wbfm --inputs expose the same runtime features as the
single-stream paths: chunked dispatch, --checkpoint/--resume, --metrics,
and --precision-derived output width (docs/ARCHITECTURE.md feature table).
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ENV = {**os.environ,
       "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
CWD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BANK_ARGS = ["-S", "96000", "-l", "12500", "--bank", "-192000,192000",
             "--iq-rate", "768000", "--channel-rate", "192000",
             "--block-seconds", "0.01"]
WBFM_ARGS = ["-S", "96000", "-l", "12500", "--wbfm",
             "--iq-rate", "240000", "--block-seconds", "0.05"]


def _cli(args):
    r = subprocess.run([sys.executable, "-m", "demodulator_tpu", *args],
                       capture_output=True, env=ENV, cwd=CWD)
    assert r.returncode == 0, r.stderr.decode()
    return r


def _bank_data(nblocks=6, seed=7):
    # --block-seconds 0.01 at 768 ksps → 7680 complex = 15360 B per block
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, nblocks * 15360, dtype=np.uint8).tobytes()


def test_bank_chunked_matches_per_block():
    """--chunk-blocks 4 (scan over the block axis) runs the identical op
    sequence as the one-block loop → byte-identical channel files."""
    tmp = tempfile.mkdtemp(prefix="bankchunk", dir="/tmp")  # no '-' in paths
    try:
        src = os.path.join(tmp, "iq.dat")
        with open(src, "wb") as f:
            f.write(_bank_data(6))
        outs = {}
        for nb in ("1", "4"):
            out = os.path.join(tmp, f"o{nb}")
            _cli(["-i", src, "-o", out, *BANK_ARGS, "--chunk-blocks", nb])
            outs[nb] = [open(f"{out}.ch{c}.raw", "rb").read()
                        for c in range(2)]
        assert outs["1"] == outs["4"]
        assert all(len(b) for b in outs["1"])
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def test_bank_chunked_checkpoint_resume_and_metrics():
    """Chunked --bank: straight run == checkpointed first half + --resume
    second half; --metrics emits a stream_done JSON line."""
    tmp = tempfile.mkdtemp(prefix="bankck", dir="/tmp")
    try:
        data = _bank_data(6, seed=9)
        src = os.path.join(tmp, "iq.dat")
        with open(src, "wb") as f:
            f.write(data)
        full = os.path.join(tmp, "full")
        r = _cli(["-i", src, "-o", full, *BANK_ARGS, "--chunk-blocks", "2",
                  "--metrics"])
        lines = [json.loads(l) for l in r.stderr.decode().splitlines()
                 if l.startswith("{")]
        done = [l for l in lines if l.get("event") == "stream_done"]
        assert done and done[0]["blocks"] == 6

        half = os.path.join(tmp, "half.dat")
        with open(half, "wb") as f:
            f.write(data[: 3 * 15360])
        ck = os.path.join(tmp, "ck.npz")
        res = os.path.join(tmp, "res")
        _cli(["-i", half, "-o", res, *BANK_ARGS, "--chunk-blocks", "2",
              "--checkpoint", ck, "--checkpoint-every", "2"])
        _cli(["-i", src, "-o", res, *BANK_ARGS, "--chunk-blocks", "2",
              "--checkpoint", ck, "--resume"])
        for c in range(2):
            a = open(f"{full}.ch{c}.raw", "rb").read()
            b = open(f"{res}.ch{c}.raw", "rb").read()
            assert a == b, f"channel {c}: {len(a)} vs {len(b)} bytes"
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _wbfm_inputs(tmp, C=2, nblocks=6, seed=11):
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    bb = WbfmPipeline(WbfmConfig(sample_rate=240000.0,
                                 block_seconds=0.05)).block_bytes
    rng = np.random.default_rng(seed)
    paths = []
    for c in range(C):
        p = os.path.join(tmp, f"st{c}.iq")
        with open(p, "wb") as f:
            f.write(rng.integers(0, 256, nblocks * bb,
                                 dtype=np.uint8).tobytes())
        paths.append(p)
    return paths, bb


def test_wbfm_bank_checkpoint_resume_metrics_and_no_spurious_out():
    """--wbfm --inputs: resume == uninterrupted; --metrics works; the -o
    template path itself is never created (only .stN.raw files)."""
    tmp = tempfile.mkdtemp(prefix="wbfmfeat", dir="/tmp")
    try:
        paths, bb = _wbfm_inputs(tmp)
        full = os.path.join(tmp, "full")
        r = _cli(["-o", full, "--inputs", ",".join(paths), *WBFM_ARGS,
                  "--metrics"])
        lines = [json.loads(l) for l in r.stderr.decode().splitlines()
                 if l.startswith("{")]
        done = [l for l in lines if l.get("event") == "stream_done"]
        assert done and done[0]["blocks"] == 6
        assert not os.path.exists(full)  # ADVICE r4: no truncating open(-o)

        # first half via truncated copies, then resume against the full files
        halves = []
        for p in paths:
            h = p + ".half"
            with open(p, "rb") as f, open(h, "wb") as g:
                g.write(f.read(3 * bb))
            halves.append(h)
        ck = os.path.join(tmp, "ck.npz")
        res = os.path.join(tmp, "res")
        _cli(["-o", res, "--inputs", ",".join(halves), *WBFM_ARGS,
              "--checkpoint", ck, "--checkpoint-every", "2"])
        _cli(["-o", res, "--inputs", ",".join(paths), *WBFM_ARGS,
              "--checkpoint", ck, "--resume"])
        for c in range(len(paths)):
            a = open(f"{full}.st{c}.raw", "rb").read()
            b = open(f"{res}.st{c}.raw", "rb").read()
            assert a == b, f"station {c}: {len(a)} vs {len(b)} bytes"
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def test_wbfm_bank_precision_output_width():
    """--precision float64 writes f64 samples, like the single-station
    path (ADVICE r4: the bank hardcoded float32)."""
    tmp = tempfile.mkdtemp(prefix="wbfmprec", dir="/tmp")
    try:
        paths, _ = _wbfm_inputs(tmp, C=1, nblocks=2)
        o32 = os.path.join(tmp, "o32")
        o64 = os.path.join(tmp, "o64")
        _cli(["-o", o32, "--inputs", paths[0], *WBFM_ARGS])
        _cli(["-o", o64, "--inputs", paths[0], *WBFM_ARGS,
              "--precision", "float64"])
        a32 = np.fromfile(f"{o32}.st0.raw", dtype=np.float32)
        a64 = np.fromfile(f"{o64}.st0.raw", dtype=np.float64)
        assert a32.size == a64.size and a32.size > 0
        np.testing.assert_allclose(a64, a32.astype(np.float64),
                                   rtol=1e-5, atol=1e-6)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
