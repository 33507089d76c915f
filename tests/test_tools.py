"""Tooling parity: rtltcp fan-out server and plot scope."""
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import rtltcp  # noqa: E402


def _fake_rtl_tcp_daemon(payload: bytes, commands_out: list):
    """Minimal rtl_tcp server: records commands, streams payload."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        c, _ = srv.accept()
        c.settimeout(5.0)

        def drain():
            try:
                while True:
                    b = c.recv(5)
                    if len(b) < 5:
                        return
                    cmd, val = struct.unpack(">BI", b)
                    commands_out.append((cmd, val))
            except OSError:
                pass

        threading.Thread(target=drain, daemon=True).start()
        time.sleep(0.2)
        try:
            c.sendall(payload)
            time.sleep(0.5)
            c.close()
        except OSError:
            pass
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1]


def test_send_command_wire_format():
    a, b = socket.socketpair()
    rtltcp.send_command(a, "frequency", 94900000)
    assert b.recv(5) == struct.pack(">BI", 0x01, 94900000)
    a.close()
    b.close()


def test_extended_command_set_wire_format():
    """The extended rtl_tcp commands (0x40-0x56; reference rtltcp.py:32-63)
    are sendable with the same one-byte + uint32-BE framing."""
    expect = {"tuner_bandwidth": 0x40, "udp_establish": 0x41,
              "udp_terminate": 0x42, "i2c_tuner_register": 0x43,
              "i2c_tuner_override": 0x44, "tuner_bw_if_center": 0x45,
              "tuner_if_mode": 0x46, "sideband": 0x47,
              "report_i2c_regs": 0x48, "gpio_set_output_mode": 0x49,
              "gpio_set_input_mode": 0x50, "gpio_get_io_status": 0x51,
              "gpio_write_pin": 0x52, "gpio_read_pin": 0x53,
              "gpio_get_byte": 0x54, "is_tuner_pll_locked": 0x55,
              "freq_hi32": 0x56}
    a, b = socket.socketpair()
    for name, code in expect.items():
        assert rtltcp.COMMANDS[name] == code
        rtltcp.send_command(a, name, 1 << 20)
        assert b.recv(5) == struct.pack(">BI", code, 1 << 20)
    a.close()
    b.close()


def test_fanout_two_clients_get_full_stream():
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    cmds: list = []
    port = _fake_rtl_tcp_daemon(payload, cmds)
    up = socket.create_connection(("127.0.0.1", port))
    rtltcp.send_command(up, "sample_rate", 250000)
    srv = rtltcp.FanOutServer(up, 0)  # ephemeral listen port
    received = [b"", b""]

    def client(i):
        c = socket.create_connection(("127.0.0.1", srv.port))
        c.settimeout(5.0)
        try:
            while True:
                d = c.recv(8192)
                if not d:
                    break
                received[i] += d
        except OSError:
            pass
        c.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.1)  # both connected before the daemon starts streaming
    for t in threads:
        t.join(timeout=10)
    srv.close()
    assert received[0] == payload
    assert received[1] == payload
    assert (0x02, 250000) in cmds  # sample_rate command reached the daemon


def test_plot_once_renders_png(tmp_path):
    pytest.importorskip("matplotlib")
    audio = np.sin(np.linspace(0, 2 * np.pi * 100, 4096)).astype(np.float32)
    out = tmp_path / "scope.png"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "plot.py"),
         "96000", "--once", str(out)],
        input=audio.tobytes(), capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert out.exists() and out.stat().st_size > 1000


def test_plot_reader_chunking():
    import plot
    import io
    data = np.arange(10000, dtype=np.float32)
    chunks = list(plot.reader(io.BytesIO(data.tobytes()), 4096, np.float32))
    assert len(chunks) == 2  # partial tail dropped
    np.testing.assert_array_equal(chunks[0], data[:4096])


def test_bench_scaling_harness():
    """Weak-scaling harness runs on a 2-device virtual mesh and emits one
    valid JSON line per device count with an efficiency field."""
    import json
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "bench_scaling.py"),
         "--virtual", "2", "--blocks-per-device", "1", "--repeats", "1"],
        capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    lines = [json.loads(l) for l in r.stdout.decode().splitlines() if l]
    assert [l["devices"] for l in lines] == [1, 2]
    assert all(l["msps"] > 0 and "efficiency" in l for l in lines)
