"""Serialized-executable warm-start cache (runtime/aot.py).

Warm CLI starts pay trace+lower+compile-cache lookup per process; the AOT
cache pickles the compiled executable and reloads it.  The reference's
analog is its millisecond binary startup (src/main.c:100-198).
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from demodulator_tpu.runtime.aot import cached_compile

CWD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multi_device_mesh_skips_aot(tmp_path):
    """The cache is single-device only (executables bake in their device
    assignment); under the 8-device test mesh it must decline."""
    d = str(tmp_path / "aot")

    def f(a, b):
        return a * 2.0 + b

    s = jax.ShapeDtypeStruct((8,), np.float32)
    assert len(jax.devices()) == 8  # conftest virtual mesh
    assert cached_compile(f, (s, s), {"t": "unit"},
                          directory=d) == (None, False)


def test_cached_compile_roundtrip_subprocess(tmp_path):
    """Serialize→deserialize→execute equals fresh-compile (1-device CPU)."""
    d = str(tmp_path / "aot")
    code = f"""
import os
import numpy as np
import jax
from demodulator_tpu.runtime.aot import cached_compile
def f(a, b):
    return a * 2.0 + b
x = np.arange(8, dtype=np.float32)
s = jax.ShapeDtypeStruct((8,), np.float32)
c1, loaded1 = cached_compile(f, (s, s), {{"t": "unit"}}, directory={d!r})
assert c1 is not None and not loaded1, "expected fresh compile"
assert len(os.listdir({d!r})) == 1
c2, loaded2 = cached_compile(f, (s, s), {{"t": "unit"}}, directory={d!r})
assert loaded2, "expected pickle load"
np.testing.assert_array_equal(np.asarray(c1(x, x)), np.asarray(c2(x, x)))
s2 = jax.ShapeDtypeStruct((16,), np.float32)
c3, _ = cached_compile(f, (s2, s2), {{"t": "unit"}}, directory={d!r})
assert c3 is not None
assert len(os.listdir({d!r})) == 2
print("OK")
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "DEMODULATOR_TPU_AOT_CACHE": "1"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       env=env, cwd=CWD)
    assert r.returncode == 0 and b"OK" in r.stdout, r.stderr.decode()


def test_cli_aot_hit_and_identical_output():
    """Two CLI runs against a fresh AOT dir: first misses, second hits,
    outputs byte-identical."""
    tmp = tempfile.mkdtemp(prefix="aotcli", dir="/tmp")  # no '-' in paths
    try:
        rng = np.random.default_rng(5)
        src = os.path.join(tmp, "iq.dat")
        rng.integers(0, 256, 20 * 4096, dtype=np.uint8).tofile(src)
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
               "JAX_COMPILATION_CACHE_DIR": os.path.join(tmp, "cache"),
               "DEMODULATOR_TPU_AOT_CACHE": "1",
               "DEMODULATOR_TPU_PHASES": "1"}
        outs, hits = [], []
        for i in range(2):
            dst = os.path.join(tmp, f"o{i}.raw")
            r = subprocess.run(
                [sys.executable, "-m", "demodulator_tpu", "-i", src,
                 "-o", dst, "-S", "192000", "-l", "12500", "-b", "-6"],
                capture_output=True, env=env, cwd=CWD)
            assert r.returncode == 0, r.stderr.decode()
            ph = [json.loads(l[len("PHASES "):]) for l in
                  r.stderr.decode().splitlines() if l.startswith("PHASES ")]
            assert ph, r.stderr.decode()
            hits.append(ph[0].get("aot_hit"))
            outs.append(open(dst, "rb").read())
        assert hits == [False, True], hits
        assert outs[0] == outs[1] and len(outs[0]) > 0
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
