"""Pipeline validation: jitted BlockPipeline vs the numpy golden model.

The acceptance bar is >=60 dB SNR vs the C reference (BASELINE.md); the
FIR-reformulated pipeline lands at 120-145 dB vs the golden model (which is
itself 140+ dB vs the C binary), with the one exception of conditioning
mode 1 whose associative-scan DC tracker rounds differently (~80 dB).
"""
import numpy as np
import pytest
import jax

from demodulator_tpu.config import config_from_cli_opts
from demodulator_tpu.models.nbfm import BlockPipeline
from demodulator_tpu.oracle.pipeline import OraclePipeline
from tests.conftest import snr_db

BASE = {"S": "192000", "l": "12500", "b": "-6"}  # bufSize 4096

CASES = [
    ({}, 110.0),
    ({"q": "1"}, 70.0),
    ({"q": "2"}, 110.0),
    ({"q": "3"}, 110.0),
    ({"L": "12500"}, 100.0),
    ({"m": "1", "e": "2"}, 110.0),
    ({"L": "12500", "m": "3", "D": "4", "d": "5"}, 100.0),
    ({"L": "9000", "D": "7", "m": "2"}, 100.0),
    ({"L": "12500", "q": "2"}, 100.0),
    ({"L": "12500", "q": "1"}, 70.0),
    ({"d": "1"}, 110.0),
]


@pytest.mark.parametrize("opts,bar", CASES,
                         ids=[str(o) for o, _ in CASES])
def test_pipeline_matches_oracle(iq_data, opts, bar):
    cfg = config_from_cli_opts({**BASE, **opts})
    orc = OraclePipeline(cfg)
    want = orc.process_stream(iq_data.tobytes())
    pipe = BlockPipeline(cfg)
    blocks = iq_data.reshape(3, 4096)
    fn = jax.jit(pipe.process_blocks)
    _, got = fn(pipe.init_state(), blocks)
    got = np.asarray(got).reshape(-1)
    s = snr_db(want, got)
    assert s > bar, f"SNR vs golden model too low: {s:.1f} dB (bar {bar})"


def test_pipeline_block_batching_consistent(iq_data):
    """Batched processing must equal block-by-block processing."""
    cfg = config_from_cli_opts(BASE)
    pipe = BlockPipeline(cfg)
    blocks = iq_data.reshape(3, 4096)
    _, batched = jax.jit(pipe.process_blocks)(pipe.init_state(), blocks)
    st = pipe.init_state()
    singles = []
    fn = jax.jit(pipe.__call__)
    for b in blocks:
        st, out = fn(st, b)
        singles.append(np.asarray(out))
    np.testing.assert_array_equal(np.asarray(batched), np.stack(singles))


def test_pipeline_stateful_q1_carries_offsets(iq_data):
    """correctIq state must evolve across blocks and alter later outputs."""
    cfg = config_from_cli_opts({**BASE, "q": "1"})
    pipe = BlockPipeline(cfg)
    blocks = iq_data.reshape(3, 4096)
    st, out_seq = jax.jit(pipe.process_blocks)(pipe.init_state(), blocks)
    assert not np.allclose(np.asarray(st.iq_off), 0.0)
    # processing block 2 with fresh state differs from carried state
    _, out_fresh = jax.jit(pipe.__call__)(pipe.init_state(), blocks[2])
    assert not np.allclose(np.asarray(out_seq)[2], np.asarray(out_fresh))


def test_demod_mode0_filter_iq_only(iq_data):
    cfg = config_from_cli_opts({**BASE, "L": "12500"})
    cfg.mode &= ~0x30  # clear demod bits → filter-IQ-only path
    orc = OraclePipeline(cfg)
    want = orc.process_block(iq_data[:4096])
    pipe = BlockPipeline(cfg)
    _, got = jax.jit(pipe.__call__)(pipe.init_state(), iq_data[:4096])
    s = snr_db(want, np.asarray(got))
    assert got.shape == (4096,)
    assert s > 100.0, f"{s:.1f} dB"


def test_fast_atan2_accuracy():
    from demodulator_tpu.ops.demod import atan2_fast
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    y = rng.standard_normal(20000).astype(np.float32) * 10
    x = rng.standard_normal(20000).astype(np.float32) * 10
    ref = np.arctan2(y, x)
    got = np.asarray(atan2_fast(jnp.asarray(y), jnp.asarray(x)))
    assert np.max(np.abs(ref - got)) < 5e-6
    # edge cases
    got0 = np.asarray(atan2_fast(jnp.asarray([0.0, 0.0, 1.0, -1.0], jnp.float32),
                                 jnp.asarray([0.0, -1.0, 0.0, 0.0], jnp.float32)))
    np.testing.assert_allclose(got0, [0.0, np.pi, np.pi / 2, -np.pi / 2],
                               atol=5e-6)


def test_fast_atan2_signed_zero_corners():
    """atan2_fast must match libm/jnp.arctan2 on every ±0 corner — the
    conj-product of a centered (0,0) IQ sample (bytes 127,127) lands on
    (±0, −0), where returning 0 instead of ±π once cost ~π glitches."""
    import itertools
    import jax.numpy as jnp
    from demodulator_tpu.ops.demod import atan2_fast
    zs = np.array([0.0, -0.0, 1.5, -1.5], np.float32)
    y, x = np.meshgrid(zs, zs, indexing="ij")
    got = np.asarray(atan2_fast(jnp.asarray(y.ravel()), jnp.asarray(x.ravel())))
    want = np.arctan2(y.ravel(), x.ravel())
    # 5e-6: the documented --fast-atan2 short-poly bound (2.52e-6 rad);
    # the ±0 corners themselves must still be exact (checked below)
    np.testing.assert_allclose(got, want, atol=5e-6)
    exact = np.abs(want) < 1e-6
    np.testing.assert_array_equal(got[exact], want[exact].astype(np.float32))
    # bit-sign agreement on the zero results too
    np.testing.assert_array_equal(np.signbit(got[np.abs(want) < 1e-6]),
                                  np.signbit(want[np.abs(want) < 1e-6]))


def test_centered_sample_block_parity(ref_binary):
    """A block full of (127,127) bytes (exact DC zeros) through the real C
    binary vs our XLA fast path — the corner the signed-zero bug broke."""
    from tests.conftest import run_reference, snr_db
    from demodulator_tpu.config import config_from_cli_opts
    from demodulator_tpu.models.nbfm import BlockPipeline
    rng = np.random.default_rng(9)
    iq = rng.integers(0, 256, 3 * 4096, dtype=np.uint8)
    iq[1000:2000] = 127  # runs of exactly-centered samples
    ref = run_reference(ref_binary, iq.tobytes(),
                        ["-S", "192000", "-l", "12500", "-b", "-6"])
    cfg = config_from_cli_opts({"S": "192000", "l": "12500", "b": "-6"})
    pipe = BlockPipeline(cfg, fast_atan2=True)
    mine = np.asarray(pipe(pipe.init_state(), iq.reshape(3, 4096))[1]).ravel()
    n = 2 * 1024  # deterministic non-final blocks
    assert snr_db(ref[:n], mine[:n]) > 110.0


def test_split_iq_matches_strided():
    """split_iq (u16-bitcast deinterleave) == conditioned strided slices,
    bit-for-bit, both conditioning kinds."""
    import jax.numpy as jnp
    from demodulator_tpu.ops import conditioning as cond_ops
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(3, 512), dtype=np.uint8)
    raw[0, :4] = [255, 0, 127, 128]  # wrap corners
    for kind, ref in [("shift", cond_ops.shift_origin),
                      ("normalize", cond_ops.normalize_input)]:
        xi, xq = cond_ops.split_iq(jnp.asarray(raw), kind=kind)
        want = np.asarray(ref(jnp.asarray(raw)))
        np.testing.assert_array_equal(np.asarray(xi), want[:, 0::2])
        np.testing.assert_array_equal(np.asarray(xq), want[:, 1::2])


def test_wbfm_call_u16_matches_u8():
    """WBFM's host-u16 entry == the uint8 entry exactly."""
    import jax.numpy as jnp
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    pipe = WbfmPipeline(WbfmConfig(block_seconds=0.01))
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=pipe.block_bytes, dtype=np.uint8)
    st = pipe.init_state()
    _, a8 = pipe(st, jnp.asarray(raw))
    _, a16 = pipe.call_u16(st, jnp.asarray(raw.view(np.uint16)))
    np.testing.assert_allclose(np.asarray(a16), np.asarray(a8), atol=1e-6)


def test_fm_demod_split_matches_interleaved():
    """fm_demod_split on pre-split even/odd pairs == fm_demod on the
    interleaved stream, including the C99 signed-zero/NaN corners."""
    import jax.numpy as jnp
    from demodulator_tpu.ops.demod import fm_demod, fm_demod_split
    rng = np.random.default_rng(11)
    x = rng.normal(size=4096).astype(np.float32)
    # corner values in a few pair slots
    x[:8] = [0.0, -0.0, 0.0, 0.0, 1.0, 0.0, 0.0, -1.0]
    q = x.reshape(-1, 4)
    for fast in (False, True):
        want = np.asarray(fm_demod(jnp.asarray(x), fast=fast))
        got = np.asarray(fm_demod_split(
            jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
            jnp.asarray(q[:, 2]), jnp.asarray(q[:, 3]), fast=fast))
        np.testing.assert_array_equal(want, got)
