"""The plain XLA NBFM path against the numpy golden model, on every chain
configuration the CLI reaches (conditioning × -L × filter family ×
discriminator), the streaming runtime's choice of that path, and the
sharded compat step against the unsharded one."""
import io

import jax
import numpy as np
import pytest

from demodulator_tpu.config import DemodConfig
from demodulator_tpu.models.nbfm import BlockPipeline
from demodulator_tpu.oracle.pipeline import OraclePipeline
from tests.conftest import snr_db

# small block: 4096 bytes → 1024 audio samples
BUF = 4096


def _raw(blocks, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(blocks, BUF), dtype=np.uint8)


def _xla(cfg, raw, fast=False):
    pipe = BlockPipeline(cfg, fast_atan2=fast)
    _, got = jax.jit(pipe.process_blocks)(pipe.init_state(), raw)
    return np.asarray(got).ravel()


@pytest.mark.parametrize("q", [0, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_flagship_matches_oracle(q, fast):
    """q0/q3 chains: exact arctan2 at the pipeline bar, the --fast-atan2
    polynomial (2.5e-6 rad) at 100 dB."""
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      buf_size=BUF, mode=0x10 | (q << 2))
    raw = _raw(3, 11 + q)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    assert snr_db(want, _xla(cfg, raw, fast)) > (100.0 if fast else 120.0)


def test_chebyshev_taps_match_oracle():
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=9500.0,
                      out_filter_degree=5, epsilon=0.25, mode=0x11,
                      buf_size=BUF)
    raw = _raw(2, 3)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    assert snr_db(want, _xla(cfg, raw, fast=True)) > 100.0


@pytest.mark.parametrize("deg,q,m", [(3, 0, 0), (2, 3, 1), (5, 0, 0),
                                     (8, 0, 2)])
def test_inlpf_matches_oracle(deg, q, m):
    """-L chain: conditioning → complex input lowpass (arena couplings
    included) → discriminator → audio lowpass."""
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=6500.0,
                      lowpass_in=12500.0, in_filter_degree=deg, buf_size=BUF)
    cfg.mode |= (q << 2) | (m & 3)
    raw = _raw(2, 3)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    assert snr_db(want, _xla(cfg, raw)) > 100.0


@pytest.mark.parametrize("m", [0, 1])
def test_dcblock_matches_oracle(m):
    """-q2: the DC-block highpass (src/matrix.c:142-157) as a complex FIR
    between conditioning and the discriminator."""
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      buf_size=BUF)
    cfg.mode |= (2 << 2) | (m & 1)
    raw = _raw(2, 7)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    assert snr_db(want, _xla(cfg, raw)) > 110.0


@pytest.mark.parametrize("deg,m", [(3, 0), (2, 1), (5, 0), (8, 2)])
def test_dcblock_inlpf_matches_oracle(deg, m):
    """-q2 -L: both complex stages, including the DC-block overrun's
    coupling into the input lowpass head and tail."""
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=6500.0,
                      lowpass_in=12500.0, in_filter_degree=deg, buf_size=BUF)
    cfg.mode |= (2 << 2) | (m & 3)
    raw = _raw(2, 11)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    assert snr_db(want, _xla(cfg, raw)) > 100.0


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_correctiq_chains_across_chunks(chunk):
    """-q1: the DC tracker carried through process_blocks chunk by chunk
    equals the oracle's sequential stream, whatever the chunking."""
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      buf_size=BUF, mode=0x10 | (1 << 2))
    raw = _raw(6, 21)
    want = OraclePipeline(cfg).process_stream(raw.tobytes())
    pipe = BlockPipeline(cfg)
    fn = jax.jit(pipe.process_blocks)
    st, outs = pipe.init_state(), []
    for b in range(0, 6, chunk):
        st, a = fn(st, raw[b:b + chunk])
        outs.append(np.asarray(a).ravel())
    assert snr_db(want, np.concatenate(outs)) > 70.0


STREAM_CASES = {
    "q0": {}, "q1": {"q": "1"}, "q2": {"q": "2"}, "q3": {"q": "3"},
    "inlpf": {"L": "12500"}, "q2_inlpf": {"q": "2", "L": "12500"},
    "f64": {"precision": "float64"},
}


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_processor_runs_plain_path(name):
    """StreamProcessor (chunked dispatch + per-block tail) writes what the
    plain jitted process_blocks computes for the whole stream: byte-equal
    for the stateless modes, f32 prefix noise for -q1."""
    from demodulator_tpu.config import config_from_cli_opts
    from demodulator_tpu.runtime.stream import StreamProcessor
    opts = {"S": "192000", "l": "12500", "b": "-6", **STREAM_CASES[name]}
    precision = opts.pop("precision", "float32")
    cfg = config_from_cli_opts(opts)
    cfg.precision = precision
    raw = _raw(10, 5)                       # 2 chunks of 4 + a 2-block tail
    proc = StreamProcessor(cfg, chunk_blocks=4, use_native=False)
    out = io.BytesIO()
    assert proc.run(io.BytesIO(raw.tobytes()), out) == 10
    got = np.frombuffer(out.getvalue(), dtype=cfg.np_dtype())
    pipe = BlockPipeline(cfg)
    _, want = jax.jit(pipe.process_blocks)(pipe.init_state(), raw)
    want = np.asarray(want).ravel()
    if name == "q1":
        assert snr_db(want, got) > 120.0
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", ["0", "3"])
def test_sharded_compat_step_bytes_equal_unsharded(q):
    """Compat q0/q3 over a 4×2 (time × chan) mesh: zero communication, so
    the sharded step writes the unsharded step's bytes."""
    from demodulator_tpu.config import config_from_cli_opts
    from demodulator_tpu.parallel.mesh import make_demod_mesh
    from demodulator_tpu.parallel.sharding import ShardedPipeline
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6",
                                "q": q})
    chunk = np.random.default_rng(9).integers(0, 256, size=(2, 8, BUF),
                                              dtype=np.uint8)
    mesh = make_demod_mesh(4, 2, devices=np.array(jax.devices()[:8]))
    _, audio = ShardedPipeline(cfg, mesh)(np.zeros((2, 2), np.float32),
                                          chunk)
    pipe = BlockPipeline(cfg)
    _, want = jax.jit(pipe.process_blocks)(pipe.init_state(),
                                           chunk.reshape(16, BUF))
    np.testing.assert_array_equal(np.asarray(audio).reshape(16, -1),
                                  np.asarray(want))
