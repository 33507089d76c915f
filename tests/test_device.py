"""What ties a run to its device: the compile-cache root, the HBM peak
table the benchmark divides by, the GPU-only bring-up script and its
comparison helpers, and the per-backend block durations."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402

_PROBE = """
import json, jax
from demodulator_tpu.cli import _enable_compile_cache
from demodulator_tpu.runtime.aot import aot_cache_dir, cache_root
_enable_compile_cache()
print(json.dumps({"root": cache_root(), "aot": aot_cache_dir(),
                  "jax": jax.config.jax_compilation_cache_dir}))
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_cache_root_is_one_fixed_directory(tmp_path, env_dir):
    """Both caches live under one root: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it; nothing else is set in code), else the checkout's
    .jax_cache.  Two processes agree on it — it never depends on a
    temporary name, a process id or the time."""
    d = None if env_dir is None else str(tmp_path / env_dir)
    a, b = _probe(d), _probe(d)
    assert a == b
    want = d if d is not None else os.path.join(REPO, ".jax_cache")
    assert a["root"] == a["jax"] == want
    assert a["aot"] == os.path.join(want, "aot")


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12),
                                       ("NVIDIA H100 NVL", 3.9e12)])
def test_hbm_peak_table(kind, peak):
    assert bench.hbm_peak(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100"])
def test_hbm_peak_unknown_device_raises(kind):
    with pytest.raises(KeyError):
        bench.hbm_peak(kind)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the bring-up script fails before any work and prints
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_snr_db():
    ref = np.sin(np.linspace(0, 20, 1000))
    assert chip_smoke.snr_db(ref, ref) == float("inf")
    assert abs(chip_smoke.snr_db(ref, 1.01 * ref) - 40.0) < 1e-9
    with pytest.raises(ValueError):
        chip_smoke.snr_db(ref, ref[:10])


def test_check_enforces_bar():
    assert "(bar >= 60)" in chip_smoke.check("snr", 61.0, 60.0)
    assert "(bar <= 2)" in chip_smoke.check("err", 1.0, 2.0, higher=False)
    with pytest.raises(AssertionError):
        chip_smoke.check("snr", 59.9, 60.0)
    with pytest.raises(AssertionError):
        chip_smoke.check("err", 2.5, 2.0, higher=False)


def test_tone_check():
    rate = 48000.0
    t = np.arange(1 << 16) / rate
    audio = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    assert abs(chip_smoke.tone_peak(audio, rate) - 1000.0) < 1.0
    chip_smoke.check_tone(audio, rate, 1000.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_tone(audio, rate, 1500.0)
    audio[5] = np.nan
    with pytest.raises(AssertionError):
        chip_smoke.check_tone(audio, rate, 1000.0)


def test_synth_is_periodic_fm_and_seeded(tmp_path):
    fs = 192000.0
    assert chip_smoke.fm_period(fs, [0.0, 1000.0]) == 192
    assert chip_smoke.fm_period(12.288e6, [192000.0, 1000.0]) == 12288
    a, b = str(tmp_path / "a.iq"), str(tmp_path / "b.iq")
    chip_smoke.synth(a, 4096, fs, [(0.0, 1000.0, 2500.0, 0.6)], seed=3)
    chip_smoke.synth(b, 4096, fs, [(0.0, 1000.0, 2500.0, 0.6)], seed=3)
    x = np.fromfile(a, np.uint8)
    assert x.size == 8192 and np.array_equal(x, np.fromfile(b, np.uint8))
    z = (x[0::2] - 127.4) + 1j * (x[1::2] - 127.4)
    inst = np.angle(z[1:] * np.conj(z[:-1])) * fs / (2 * np.pi)
    # the instantaneous frequency is 2.5 kHz · sin(2π·1 kHz·t)
    t = (np.arange(inst.size) + 0.5) / fs
    dev = 2.0 * np.mean(inst * np.sin(2 * np.pi * 1000.0 * t))
    assert abs(dev - 2500.0) < 100.0, dev


def test_block_seconds_per_backend(monkeypatch):
    import jax
    from demodulator_tpu import config
    assert config.default_block_seconds("wbfm") == 0.1     # CPU: fast tests
    assert config.default_block_seconds("bank") == 0.01
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert config.default_block_seconds("wbfm") == \
        config.BLOCK_SECONDS["gpu"]["wbfm"]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(ValueError):
        config.default_block_seconds("bank")
