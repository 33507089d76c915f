"""Test configuration: force an 8-device virtual CPU mesh before JAX import,
and provide the compiled C reference binary as a golden oracle."""
import os
import subprocess
import sys

# Force a hermetic virtual 8-device CPU mesh, also on a machine with a GPU:
# the env var covers subprocesses, jax.config this process (it works any
# time before the first backend initialization).
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SRC = "/root/reference"
REF_BUILD = os.path.join(REPO, ".ref_build")


def _build_ref(subdir: str, cmake_args):
    path = os.path.join(REF_BUILD, subdir) if subdir else REF_BUILD
    binary = os.path.join(path, "demodulator")
    if os.path.exists(binary):
        return binary
    os.makedirs(path, exist_ok=True)
    subprocess.run(["cmake", "-G", "Ninja", "-DCMAKE_BUILD_TYPE=Release",
                    *cmake_args, REF_SRC], cwd=path, check=True,
                   capture_output=True)
    subprocess.run(["ninja"], cwd=path, check=True, capture_output=True)
    return binary


@pytest.fixture(scope="session")
def ref_binary():
    """Path to the compiled reference demodulator (float32 build)."""
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference sources not available")
    return _build_ref("", [])


@pytest.fixture(scope="session")
def ref_binary_verbose():
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference sources not available")
    return _build_ref("verbose", ["-DIS_VERBOSE=ON"])


@pytest.fixture(scope="session")
def ref_harness():
    """Isolated driver around the reference's exported filter functions."""
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference sources not available")
    path = os.path.join(REF_BUILD, "harness")
    binary = os.path.join(path, "drv")
    if not os.path.exists(binary):
        os.makedirs(path, exist_ok=True)
        src = os.path.join(path, "drv.c")
        with open(src, "w") as f:
            f.write(r'''
// Test-only driver: calls the reference's exported filter functions on
// stdin data to produce isolated ground truth. Not part of the framework.
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "filter.h"
int main(int argc, char **argv) {
    int cplx = strcmp(argv[1], "cplx") == 0;
    size_t len = strtoul(argv[2], 0, 10);
    size_t sosLen = strtoul(argv[3], 0, 10);
    REAL (*sos)[6] = calloc(sosLen, sizeof(*sos));
    for (size_t m = 0; m < sosLen; ++m)
        for (int j = 0; j < 6; ++j)
            sos[m][j] = (REAL) strtod(argv[4 + 6*m + j], 0);
    REAL *x = calloc(len * 4, sizeof(REAL));
    REAL *y = calloc(len * 4, sizeof(REAL));
    if (fread(x, sizeof(REAL), len, stdin) != len) return 1;
    if (cplx) applyComplexFilter(x, y, len, sosLen, sos);
    else applyFilter(x, y, len, sosLen, sos);
    fwrite(y, sizeof(REAL), len, stdout);
    return 0;
}
''')
        subprocess.run(["gcc", "-O2", f"-I{REF_SRC}/include", src,
                        f"{REF_SRC}/src/filter.c", "-o", binary, "-lm"],
                       check=True, capture_output=True)
    return binary


@pytest.fixture(scope="session")
def iq_data():
    """Deterministic synthetic uint8 IQ: FM tone + noise, 3 full test blocks."""
    rng = np.random.default_rng(42)
    n = 4096 * 3
    t = np.arange(n // 2) / 192000.0
    # NBFM: 1 kHz tone, 2.5 kHz deviation
    phase = 2 * np.pi * np.cumsum(2500.0 * np.sin(2 * np.pi * 1000.0 * t)) / 192000.0
    iq = np.exp(1j * phase) * 80
    iq += (rng.standard_normal(n // 2) + 1j * rng.standard_normal(n // 2)) * 4
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = np.clip(np.round(iq.real + 127.4), 0, 255).astype(np.uint8)
    out[1::2] = np.clip(np.round(iq.imag + 127.4), 0, 255).astype(np.uint8)
    return out


def run_reference(binary, data: bytes, cli_args) -> np.ndarray:
    """Run the reference binary on bytes via temp files, return float32 out."""
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".dat") as fin, \
            tempfile.NamedTemporaryFile(suffix=".f32") as fout:
        fin.write(data)
        fin.flush()
        subprocess.run([binary, "-i", fin.name, "-o", fout.name, *cli_args],
                       check=True, capture_output=True)
        return np.fromfile(fout.name, dtype=np.float32)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    assert ref.shape == test.shape, (ref.shape, test.shape)
    err = ref.astype(np.float64) - test.astype(np.float64)
    p = float(np.mean(ref.astype(np.float64) ** 2))
    e = float(np.mean(err ** 2))
    if e == 0:
        return float("inf")
    return 10 * np.log10(p / e) if p > 0 else float("-inf")
