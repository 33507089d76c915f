"""PFB channelizer: exactness vs naive per-channel mix+decimate,
streaming continuity, and grid mapping."""
import numpy as np
import pytest

from demodulator_tpu.ops.channelizer import (PolyphaseChannelizer,
                                             design_pfb_prototype)


def naive_channels(h, x, C, M):
    """d_k[m] = Σ_j h[j]·x[mC − j]·e^{j2πkj/C}; x zero before t=0."""
    K = len(h)
    out = np.zeros((C, M), np.complex128)
    for k in range(C):
        rot = np.exp(2j * np.pi * k * np.arange(K) / C)
        for m in range(M):
            acc = 0.0 + 0.0j
            for j in range(K):
                idx = m * C - j
                if 0 <= idx < len(x):
                    acc += h[j] * x[idx] * rot[j]
            out[k, m] = acc
    return out


def _iq_of(x):
    return np.stack([x.real, x.imag]).astype(np.float32)


def _cplx_of(y):
    y = np.asarray(y)
    return y[..., 0, :] + 1j * y[..., 1, :]


@pytest.mark.parametrize("C,P", [(4, 3), (8, 4)])
def test_matches_naive(C, P):
    rng = np.random.default_rng(0)
    h = rng.normal(size=P * C)
    ch = PolyphaseChannelizer(C, prototype=h)
    T = 6 * C
    x = (rng.normal(size=T) + 1j * rng.normal(size=T)).astype(np.complex64)
    y, _ = ch(_iq_of(x), ch.init_hist())
    want = naive_channels(h, x, C, T // C)
    np.testing.assert_allclose(_cplx_of(y), want, atol=1e-4)


def test_streaming_continuity():
    C = 8
    ch = PolyphaseChannelizer(C, taps_per_phase=6)
    rng = np.random.default_rng(1)
    T = 16 * C
    x = (rng.normal(size=4 * T) + 1j * rng.normal(size=4 * T)
         ).astype(np.complex64)
    whole, _ = ch(_iq_of(x), ch.init_hist())
    hist = ch.init_hist()
    parts = []
    for b in range(4):
        y, hist = ch(_iq_of(x[b * T:(b + 1) * T]), hist)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts, axis=-1),
                               np.asarray(whole), atol=1e-5)


def test_tone_lands_in_its_channel():
    """A tone at k·fs/C + δ appears in channel k at frequency δ, and is
    rejected (>60 dB) everywhere else."""
    C, fs = 16, 1.6e6
    ch = PolyphaseChannelizer(C, taps_per_phase=12)
    T = 128 * C
    t = np.arange(T) / fs
    k, delta = 5, 11000.0
    x = np.exp(2j * np.pi * (k * fs / C + delta) * t).astype(np.complex64)
    y, _ = ch(_iq_of(x), ch.init_hist())
    y = _cplx_of(y)[:, 32:]  # settle
    powers = np.mean(np.abs(y) ** 2, axis=-1)
    assert np.argmax(powers) == k
    others = powers[np.arange(C) != k]
    assert 10 * np.log10(powers[k] / others.max()) > 60.0
    # recovered frequency inside the channel
    f = np.fft.fftfreq(y.shape[-1], C / fs)
    mag = np.abs(np.fft.fft(y[k] * np.hanning(y.shape[-1])))
    assert abs(f[np.argmax(mag)] - delta) < fs / C / y.shape[-1] * 2


def test_negative_offset_wraps():
    C, fs = 8, 800000.0
    ch = PolyphaseChannelizer(C)
    assert ch.channel_index(-100000.0, fs) == 7
    assert ch.channel_index(100000.0, fs) == 1
    assert ch.channel_index(0.0, fs) == 0
    with pytest.raises(ValueError):
        ch.channel_index(12345.0, fs)


def test_prototype_design():
    h = design_pfb_prototype(16, taps_per_phase=8)
    assert h.size == 128 and abs(h.sum() - 1.0) < 1e-12


@pytest.mark.parametrize("C,P", [(8, 12), (8, 7), (4, 3), (16, 5)])
def test_call_split_matches_call(C, P):
    """call_split's four planes interleave back to __call__'s output (the
    parity split and tap×DFT folding happen in host matrices; matmul
    reduction order differs, so ~1-ulp tolerance) and carry the same
    history.  Odd P exercises the even-parity extra frame + left pad.

    The context pins default-precision dots to HIGHEST for a
    backend-independent comparison."""
    import jax
    import jax.numpy as jnp
    from demodulator_tpu.ops.channelizer import PolyphaseChannelizer
    rng = np.random.default_rng(9)
    pfb = PolyphaseChannelizer(C, taps_per_phase=P)
    T = C * 2 * 40
    x = rng.normal(size=(2, T)).astype(np.float32)
    h0 = pfb.init_hist()
    with jax.default_matmul_precision("highest"):
        y, h1 = pfb(jnp.asarray(x), h0)       # [C, 2, T/C]
    yer, yei, yor, yoi, h2 = pfb.call_split(jnp.asarray(x), h0)
    y = np.asarray(y)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_allclose(y[:, 0, 0::2].T, np.asarray(yer),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[:, 1, 0::2].T, np.asarray(yei),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[:, 0, 1::2].T, np.asarray(yor),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[:, 1, 1::2].T, np.asarray(yoi),
                               rtol=1e-4, atol=1e-5)


def test_call_split_streaming_continuity():
    """Blocked call_split == one-shot call_split (history carry)."""
    import jax.numpy as jnp
    from demodulator_tpu.ops.channelizer import PolyphaseChannelizer
    rng = np.random.default_rng(10)
    pfb = PolyphaseChannelizer(4)
    T = 4 * 2 * 30
    x = rng.normal(size=(2, 4 * T)).astype(np.float32)
    whole = pfb.call_split(jnp.asarray(x), pfb.init_hist())
    h = pfb.init_hist()
    parts = [[] for _ in range(4)]
    for b in range(4):
        out = pfb.call_split(jnp.asarray(x[:, b * T:(b + 1) * T]), h)
        h = out[4]
        for k in range(4):
            parts[k].append(np.asarray(out[k]))
    for k in range(4):
        np.testing.assert_allclose(np.concatenate(parts[k], axis=0),
                                   np.asarray(whole[k]), atol=1e-5)


def test_call_split_vpu_matches_call_split():
    """call_split_vpu (C=64: elementwise branch filter + single DFT einsum,
    flips folded into host constants) == call_split, planes and
    history, plus streaming continuity over 3 blocks."""
    import jax.numpy as jnp
    from demodulator_tpu.ops.channelizer import PolyphaseChannelizer
    rng = np.random.default_rng(12)
    C = 64
    pfb = PolyphaseChannelizer(C)
    T = 128 * 24
    x = rng.normal(size=(2, 3 * T)).astype(np.float32) * 100
    h0 = pfb.init_hist()
    want = pfb.call_split(jnp.asarray(x), h0)
    hv = h0
    parts = [[] for _ in range(4)]
    for b in range(3):
        out = pfb.call_split_vpu(jnp.asarray(x[:, b * T:(b + 1) * T]), hv)
        hv = out[4]
        for k in range(4):
            parts[k].append(np.asarray(out[k]))
    for k in range(4):
        got = np.concatenate(parts[k], axis=0)
        np.testing.assert_allclose(got, np.asarray(want[k]),
                                   rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(np.asarray(hv), np.asarray(want[4]))


@pytest.mark.parametrize("C", [4, 8, 16, 32, 64])
def test_call_split_streaming_matches_float64_call(C):
    """call_split (float32, fed block by block with its carried history)
    against __call__ in float64 on the whole stream: the folded einsums
    keep the float32 front within ~1e-6 of the exact channelizer."""
    import jax.numpy as jnp
    from tests.conftest import snr_db
    rng = np.random.default_rng(C)
    T = 2 * C * 24
    x = rng.integers(-128, 128, size=(2, 3 * T)).astype(np.float32)
    ref = PolyphaseChannelizer(C, dtype=jnp.float64)
    y64, _ = ref(jnp.asarray(x, jnp.float64), ref.init_hist())
    y64 = np.asarray(y64)                       # [C, 2, 3T/C]
    want = (y64[:, 0, 0::2].T, y64[:, 1, 0::2].T,
            y64[:, 0, 1::2].T, y64[:, 1, 1::2].T)
    pfb = PolyphaseChannelizer(C)
    h = pfb.init_hist()
    parts = [[] for _ in range(4)]
    for b in range(3):
        out = pfb.call_split(jnp.asarray(x[:, b * T:(b + 1) * T]), h)
        h = out[4]
        for k in range(4):
            parts[k].append(np.asarray(out[k]))
    for k in range(4):
        got = np.concatenate(parts[k], axis=0)
        assert snr_db(want[k], got) > 110.0, (k, snr_db(want[k], got))
