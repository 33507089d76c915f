"""Failure-path parity with the reference's exitFlag taxonomy
(src/main.c:49-56,78-87): -2 for a stream read error (ferror), -3 for
starvation (zero read with neither EOF nor error).  The reference keeps
these in its exitFlag; this CLI surfaces them as process exit codes
(& 0xFF: 254 / 253) instead of Python tracebacks."""
import errno
import os
import subprocess
import sys

import numpy as np
import pytest

ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
CWD = os.path.dirname(os.path.dirname(__file__))
CMD = [sys.executable, "-m", "demodulator_tpu", "-i", "-", "-o", "-",
       "-S", "192000", "-l", "12500", "-b", "-6"]


def test_read_error_exits_minus_2():
    """A pty master whose slave has closed returns EIO mid-stream — the
    ferror analog.  One full block arrives first, so the error hits the
    steady-state read loop, not argument handling."""
    master, slave = os.openpty()
    try:
        os.set_blocking(master, True)
        # a terminal mangles raw bytes (\n→\r\n, ^C, flow control): make the
        # slave transparent before feeding IQ through it
        import termios
        import tty
        tty.setraw(slave)
        p = subprocess.Popen(CMD, stdin=master, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, env=ENV, cwd=CWD)
        data = np.full(4096, 0x55, dtype=np.uint8).tobytes()
        os.write(slave, data)
        os.close(slave)  # EOF on a pty master = EIO, not a clean EOF
        _, err = p.communicate(timeout=120)
        assert p.returncode == 254, (p.returncode, err.decode())
        assert b"stream error" in err
    finally:
        os.close(master)


def test_starved_input_exits_minus_3():
    """A non-blocking empty pipe (writer still open) reads None — the
    reference's 'zero read, no EOF, no error' starvation case."""
    r, w = os.pipe()
    try:
        os.set_blocking(r, False)
        env = {**ENV, "DEMODULATOR_TPU_NO_NATIVE": "1"}
        p = subprocess.Popen(CMD, stdin=r, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, env=env, cwd=CWD)
        _, err = p.communicate(timeout=120)
        assert p.returncode == 253, (p.returncode, err.decode())
        assert b"starved" in err
    finally:
        os.close(r)
        os.close(w)


def test_clean_eof_exits_zero():
    r = subprocess.run(CMD, input=b"\x7f" * 8192, capture_output=True,
                       env=ENV, cwd=CWD)
    assert r.returncode == 0, r.stderr.decode()
