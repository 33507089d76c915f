"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Exercises the same shard_map code paths that run on a multi-GPU host:
(time × chan) mesh, correctIq cross-shard affine prefix (all_gather), and
continuous-profile halo exchange (ppermute).
"""
import numpy as np
import pytest
import jax

from demodulator_tpu.config import config_from_cli_opts
from demodulator_tpu.models.nbfm import BlockPipeline
from demodulator_tpu.parallel.mesh import make_demod_mesh
from demodulator_tpu.parallel.sharding import ShardedPipeline
from tests.conftest import snr_db

BASE = {"S": "192000", "l": "12500", "b": "-6"}


@pytest.fixture(scope="module")
def chunk():
    rng = np.random.default_rng(9)
    return rng.integers(0, 256, size=(2, 8, 4096), dtype=np.uint8)


def _single_device_truth(cfg_opts, raw):
    cfg = config_from_cli_opts(cfg_opts)
    pipe = BlockPipeline(cfg)
    st = pipe.init_state((raw.shape[0],))
    if cfg.conditioning_kind() == 1:
        def step(s, blk):
            return pipe(s, blk)
        _, want = jax.lax.scan(step, st, np.swapaxes(raw, 0, 1))
        return np.swapaxes(np.asarray(want), 0, 1)
    _, want = pipe(st, raw)
    return np.asarray(want)


@pytest.mark.parametrize("q", ["0", "1", "2", "3"])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 2)])
def test_compat_sharding_matches_single_device(chunk, q, shape):
    opts = {**BASE, "q": q}
    mesh = make_demod_mesh(*shape,
                           devices=np.array(jax.devices()[: shape[0] * shape[1]]))
    cfg = config_from_cli_opts(opts)
    sp = ShardedPipeline(cfg, mesh)
    off0 = np.zeros((2, 2), np.float32)
    _, audio = sp(off0, chunk)
    want = _single_device_truth(opts, chunk)
    s = snr_db(want.reshape(-1), np.asarray(audio).reshape(-1))
    bar = 70.0 if q == "1" else 120.0
    assert s > bar, f"{s:.1f} dB"


def test_compat_sharding_with_input_filter(chunk):
    opts = {**BASE, "L": "12500"}
    mesh = make_demod_mesh(4, 2)
    cfg = config_from_cli_opts(opts)
    sp = ShardedPipeline(cfg, mesh)
    _, audio = sp(np.zeros((2, 2), np.float32), chunk)
    want = _single_device_truth(opts, chunk)
    s = snr_db(want.reshape(-1), np.asarray(audio).reshape(-1))
    assert s > 110.0, f"{s:.1f} dB"


@pytest.mark.parametrize("opts_extra", [{}, {"L": "12500"}, {"q": "2"}])
def test_continuous_interior_matches_and_boundaries_are_smooth(chunk, opts_extra):
    """Continuous profile: interior equals compat; block boundaries carry
    real data across shards instead of zero-state transients."""
    opts = {**BASE, **opts_extra}
    mesh = make_demod_mesh(4, 2)
    cfg = config_from_cli_opts(opts)
    cfg.profile = "continuous"
    sp = ShardedPipeline(cfg, mesh)
    _, audio = sp(np.zeros((2, 2), np.float32), chunk)
    audio = np.asarray(audio)
    want = _single_device_truth(opts, chunk)
    s = snr_db(want[:, :, 64:-64].reshape(-1), audio[:, :, 64:-64].reshape(-1))
    assert s > 120.0, f"interior {s:.1f} dB"
    # compat zeroes the first sosLen audio samples of every block;
    # continuous must not (no transient)
    assert np.all(audio[:, 1:, 0] != 0.0)


def test_continuous_equals_unsharded_continuous(chunk):
    """Same continuous semantics on 1 vs 8 time shards (halo correctness)."""
    opts = {**BASE}
    cfg = config_from_cli_opts(opts)
    cfg.profile = "continuous"
    mesh8 = make_demod_mesh(8, 1)
    mesh1 = make_demod_mesh(1, 1, devices=np.array(jax.devices()[:1]))
    a8 = np.asarray(ShardedPipeline(cfg, mesh8)(np.zeros((2, 2), np.float32),
                                                chunk)[1])
    a1 = np.asarray(ShardedPipeline(cfg, mesh1)(np.zeros((2, 2), np.float32),
                                                chunk)[1])
    np.testing.assert_allclose(a8, a1, atol=1e-5)


def test_correct_iq_state_chain_across_shards(chunk):
    """The returned carry state must equal the sequential chain's end state."""
    opts = {**BASE, "q": "1"}
    cfg = config_from_cli_opts(opts)
    mesh = make_demod_mesh(4, 2)
    sp = ShardedPipeline(cfg, mesh)
    new_off, _ = sp(np.zeros((2, 2), np.float32), chunk)
    pipe = BlockPipeline(config_from_cli_opts(opts))
    st = pipe.init_state((2,))
    for j in range(chunk.shape[1]):
        st, _ = pipe(st, chunk[:, j])
    np.testing.assert_allclose(np.asarray(new_off), np.asarray(st.iq_off),
                               rtol=2e-3, atol=2e-2)


def test_wbfm_multistation_sharded_matches_unsharded():
    """Multi-station WBFM bank: a [C]-leading batch sharded over the chan
    axis (WbfmPipeline.shard_over — zero-communication DP) equals the
    unsharded batch, blockwise over a 3-block stream (histories carry)."""
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    cfg = WbfmConfig(sample_rate=240000.0, audio_rate=48000.0,
                     block_seconds=0.05)
    pipe = WbfmPipeline(cfg)
    C = 4
    rng = np.random.default_rng(17)
    blocks = rng.integers(0, 256, size=(3, C, pipe.block_bytes),
                          dtype=np.uint8)

    st = pipe.init_state((C,))
    want = []
    for b in blocks:
        st, audio = pipe.call_u16(st, b.view(np.uint16))
        want.append(np.asarray(audio))

    mesh = make_demod_mesh(n_time=1, n_chan=C,
                           devices=np.array(jax.devices()[:C]))
    st_s = pipe.init_state((C,))
    st_s, chan_sh = pipe.shard_over(mesh, st_s)
    fn = jax.jit(pipe.call_u16, donate_argnums=(0,))
    for k, b in enumerate(blocks):
        dev = jax.device_put(b.view(np.uint16), chan_sh)
        st_s, audio = fn(st_s, dev)
        # the station axis stays distributed across the mesh's devices
        assert len(audio.sharding.device_set) == C, audio.sharding
        np.testing.assert_allclose(np.asarray(audio), want[k],
                                   rtol=1e-5, atol=1e-5)


def test_wbfm_station_bank_cli():
    """--wbfm --inputs f1,..,f4 --shard-chan 2 (subprocess, 2 virtual
    devices): per-station outputs equal C independent single-station
    WBFM runs (same pipeline, C=1)."""
    import io
    import os
    import subprocess
    import sys
    import tempfile
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    from demodulator_tpu.runtime.stream import StreamProcessor
    rng = np.random.default_rng(23)
    C = 4
    wcfg = WbfmConfig(sample_rate=240000.0, block_seconds=0.05)
    probe = WbfmPipeline(wcfg)
    nbytes = 3 * probe.block_bytes + 37      # partial tail dropped
    tmp = tempfile.mkdtemp(prefix="wbfmbank", dir="/tmp")  # no '-' in paths
    try:
        paths = []
        for c in range(C):
            p = os.path.join(tmp, f"st{c}.iq")
            with open(p, "wb") as f:
                f.write(rng.integers(0, 256, nbytes, dtype=np.uint8)
                        .tobytes())
            paths.append(p)
        out = os.path.join(tmp, "bank")
        cwd = os.path.dirname(os.path.dirname(__file__))
        env = {**os.environ,
               "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
        r = subprocess.run(
            [sys.executable, "-m", "demodulator_tpu", "-o", out,
             "--wbfm", "--inputs", ",".join(paths),
             "--iq-rate", "240000", "--block-seconds", "0.05",
             "--shard-chan", "2", "-S", "96000", "-l", "12500"],
            capture_output=True, env=env, cwd=cwd)
        assert r.returncode == 0, r.stderr.decode()
        ccfg = config_from_cli_opts({"S": "96000", "l": "12500"})
        for c in range(C):
            proc = StreamProcessor(ccfg, pipeline=WbfmPipeline(wcfg),
                                   use_native=False)
            single = io.BytesIO()
            with open(paths[c], "rb") as f:
                proc.run(f, single, tail_policy="drop")
            got = np.fromfile(f"{out}.st{c}.raw", dtype=np.float32)
            want = np.frombuffer(single.getvalue(), dtype=np.float32)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
