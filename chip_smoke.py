#!/usr/bin/env python3
"""Bring-up check of the demodulator on the GPU, through the CLI.

    python chip_smoke.py [--seed 0]      # one card: every CLI family
    python chip_smoke.py --cards 4       # four cards: only the multi-card
                                         # paths and their one-card twins

Every phase runs ``demodulator_tpu.cli.main(argv)`` in THIS process (a JAX
process reserves most of a card's memory when it starts, so a CLI child
would fail for want of memory) on FM IQ synthesized from ``--seed``, at the
sizes an SDR user records, and compares what it wrote:

* NBFM modes with the numpy oracle (``oracle/pipeline.py``) on 8 blocks
  spread over the file, first and last included (the first 8 blocks for
  -q1, whose DC tracker chains across blocks), at the SNR bars the CPU tests
  pin (tests/test_pipeline.py); the whole output is checked for length,
  finiteness and the modulating tone.
* WBFM and the channel banks with the same pipeline run on the host CPU at
  Precision.HIGHEST, on the first blocks, at the bars in ``BARS`` (banks:
  the channels that carry a station; a noise-only channel's discriminator
  output is chaotic and is only checked for length and finiteness); plus
  the tone of every station or channel.
* Four cards: each sharded path against the one-card output of the same
  input, byte-equal for compat q0, else at the CPU sharding tests'
  tolerances.

Each phase runs its CLI command twice and prints one line: name, wall
seconds of the first (compiling) and second run, Msamples/s of complex IQ
in the second, the comparison with its value and bar, and the card as
nvidia-smi names it.
The last line is one JSON object ``{"ok": true, "device": {...}}``; any
failure raises, exits non-zero and prints no such line.  Without a GPU the
script exits non-zero before doing any work.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import sys
import time

import numpy as np

BLOCK = 262144                 # the CLI's default bufSize (bytes)
WORK = ".smoke"                # scratch under the working directory; a
# relative path, since the CLI reads any -i/-o argument containing '-' as
# stdin/stdout

# Acceptance bars (dB SNR unless noted).  NBFM: vs the float32 numpy oracle,
# tests/test_pipeline.py CASES (fast atan2: the project's 60 dB bar);
# float64: vs the float64 oracle, tests/test_precision.py.  WBFM / banks:
# vs the same pipeline on the CPU at HIGHEST — tests/test_wbfm.py
# test_split2_decimator_accuracy (90 dB); 80 dB for the banks' audio.
BARS = {"nbfm_q0": 110.0, "nbfm_q0_fast": 60.0, "nbfm_inlpf": 100.0,
        "nbfm_q1": 70.0, "nbfm_q2_inlpf": 100.0, "nbfm_f64": 200.0,
        "wbfm": 90.0, "bank_pfb64": 80.0, "bank_mixer8": 80.0}


# ---------------------------------------------------------------- helpers
def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """10·log10(signal power / error power) of ``test`` against ``ref``."""
    ref = np.asarray(ref, np.float64).ravel()
    test = np.asarray(test, np.float64).ravel()
    if ref.shape != test.shape:
        raise ValueError(f"shape {test.shape} != reference {ref.shape}")
    err = float(np.mean((ref - test) ** 2))
    if err == 0.0:
        return math.inf
    return 10.0 * math.log10(float(np.mean(ref ** 2)) / err)


def check(name: str, value: float, bar: float, higher: bool = True) -> str:
    """Raise unless ``value`` meets ``bar``; return the comparison text."""
    ok = value >= bar if higher else value <= bar
    rel = ">=" if higher else "<="
    text = f"{name} {value:.2f} (bar {rel} {bar:g})"
    if not ok:
        raise AssertionError(f"failed: {text}")
    return text


def tone_peak(audio: np.ndarray, rate: float) -> float:
    """Frequency of the strongest spectral line above 100 Hz."""
    a = np.asarray(audio, np.float64)
    a = a - a.mean()
    mag = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    f = np.fft.rfftfreq(a.size, 1.0 / rate)
    keep = f > 100.0
    return float(f[keep][np.argmax(mag[keep])])


def check_tone(audio: np.ndarray, rate: float, tone: float) -> str:
    """The modulating tone must be the strongest line, within 2 bins."""
    a = np.asarray(audio)[: 1 << 18]
    if not np.all(np.isfinite(a)):
        raise AssertionError("non-finite audio")
    peak = tone_peak(a, rate)
    return check("tone_err_hz", abs(peak - tone), 2.0 * rate / a.size,
                 higher=False)


def fm_period(fs: float, freqs) -> int:
    """Samples after which a sum of carriers/tones at ``freqs`` repeats."""
    g = int(round(fs))
    for f in freqs:
        g = math.gcd(g, int(round(abs(f))))
    return int(round(fs)) // g


def synth(path: str, n_complex: int, fs: float, carriers, seed: int,
          noise: float = 0.02) -> None:
    """uint8 interleaved IQ: Σ amp·exp(j(2π·off·t + (dev/tone)(1−cos 2π·
    tone·t))) over ``carriers`` = [(offset, tone, dev, amp)], plus complex
    Gaussian noise from ``seed``.  The clean part repeats with
    fm_period(), so one period is tiled and only the noise is drawn per
    sample (fast, bit-reproducible for a seed)."""
    freqs = [c[0] for c in carriers] + [c[1] for c in carriers]
    P = fm_period(fs, freqs)
    t = np.arange(P) / fs
    base = np.zeros(P, np.complex128)
    for off, tone, dev, amp in carriers:
        ph = 2 * np.pi * off * t + (dev / tone) * (1 - np.cos(2 * np.pi * tone * t))
        base += amp * np.exp(1j * ph)
    rng = np.random.default_rng(seed)
    chunk = P * max(1, (1 << 22) // P)
    with open(path, "wb") as f:
        left = n_complex
        while left > 0:
            m = min(chunk, left)
            z = np.tile(base, -(-m // P))[:m]
            z = z + noise * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
            iq = np.empty(2 * m, np.float64)
            iq[0::2], iq[1::2] = z.real, z.imag
            f.write(np.clip(np.round(iq * 127.0 + 127.4), 0, 255)
                    .astype(np.uint8).tobytes())
            left -= m


def run_cli(argv) -> tuple[float, dict]:
    """demodulator_tpu.cli.main in this process → (wall s, PHASES dict)."""
    from demodulator_tpu import cli
    os.environ["DEMODULATOR_TPU_PHASES"] = "1"
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} → {rc}\n{err.getvalue()}")
    phases = {}
    for line in err.getvalue().splitlines():
        if line.startswith("PHASES "):
            phases = json.loads(line[len("PHASES "):])
    return wall, phases


def run_cli_twice(argv) -> tuple[float, float]:
    """(wall of a first, compiling run, wall of a second run)."""
    return run_cli(argv)[0], run_cli(argv)[0]


class Report:
    def __init__(self, card: str):
        self.card = card

    def phase(self, name, walls, n_complex, *checks):
        cold, warm = walls
        print(f"phase {name}: wall {cold:.3f} s first, {warm:.3f} s second, "
              f"{n_complex / warm / 1e6:.1f} Msamples/s; "
              + "; ".join(checks) + f"; card {self.card}", flush=True)


def _on_cpu(fn, *args):
    """Run ``fn`` jitted on the host CPU (the reference of the GPU run)."""
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.jit(fn)(*args)


# ------------------------------------------------------------ one card
NBFM = [  # name, CLI options beyond -i/-o, blocks (of 1024 at full size)
    ("nbfm_q0", ["-S", "96000", "-l", "12500"], 1024),
    ("nbfm_q0_fast", ["-S", "96000", "-l", "12500", "--fast-atan2"], 1024),
    ("nbfm_inlpf", ["-S", "96000", "-L", "12500", "-l", "6500"], 1024),
    ("nbfm_q1", ["-S", "96000", "-l", "12500", "-q", "1"], 1024),
    ("nbfm_q2_inlpf", ["-S", "96000", "-l", "12500", "-q", "2",
                       "-L", "12500"], 1024),
    ("nbfm_f64", ["-S", "96000", "-l", "12500", "--precision", "float64"],
     64),
]


def nbfm_phases(rep: Report, seed: int, blocks: int = 1024):
    from demodulator_tpu.cli import parse_args
    from demodulator_tpu.config import config_from_cli_opts
    from demodulator_tpu.oracle.pipeline import OraclePipeline
    fs, tone = 192000.0, 1000.0
    src = os.path.join(WORK, "nbfm.iq")
    synth(src, blocks * BLOCK // 2, fs, [(0.0, tone, 2500.0, 0.63)], seed)
    raw = np.memmap(src, np.uint8, "r")
    ttfo = []
    for name, opts_argv, nb in NBFM:
        nb = nb * blocks // 1024
        path = src
        if nb != blocks:
            path = os.path.join(WORK, f"{name}.iq")
            with open(path, "wb") as f:
                f.write(raw[: nb * BLOCK].tobytes())
        out = os.path.join(WORK, f"{name}.raw")
        argv = ["-i", path, "-o", out, *opts_argv]
        cold, ph = run_cli(argv)
        warm, ph2 = run_cli(argv)
        if name == "nbfm_q0":
            # the process's first CLI call is cold (unless the compile
            # cache came warm with the machine); the repeat finds the
            # compile cache and the AOT executable
            ttfo = [p["build_s"] + p["first_output_s"] for p in (ph, ph2)]
            print(f"nbfm_q0 time to first output: first {ttfo[0]:.3f} s, "
                  f"second {ttfo[1]:.3f} s (aot_hit {ph2.get('aot_hit')})",
                  flush=True)
        opts, extras = parse_args(opts_argv)
        cfg = config_from_cli_opts(opts)
        cfg.precision = extras["precision"]
        dt = cfg.np_dtype()
        got = np.fromfile(out, dt)
        n4 = BLOCK // 4
        if got.size != nb * n4:
            raise AssertionError(f"{name}: {got.size} samples, want {nb * n4}")
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{name}: non-finite audio")
        got = got.reshape(nb, n4)
        orc = OraclePipeline(cfg, dtype=dt)
        if cfg.conditioning_kind() == 1:
            idx = np.arange(8)
            want = orc.process_stream(raw[: 8 * BLOCK].tobytes()).reshape(8, n4)
        else:
            idx = np.unique(np.linspace(0, nb - 1, 8).astype(int))
            want = np.stack([orc.process_block(np.asarray(
                raw[i * BLOCK:(i + 1) * BLOCK])) for i in idx])
        s = min(snr_db(w, g) for w, g in zip(want, got[idx]))
        rep.phase(name, (cold, warm), nb * BLOCK // 2,
                  check(f"snr_vs_oracle_db[{len(idx)} blocks]", s,
                        BARS[name]),
                  check_tone(got.ravel()[n4:], fs / 2, tone))
        os.remove(out)


def wbfm_phase(rep: Report, seed: int, seconds: float = 60.0):
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    from demodulator_tpu.ops.resample import PolyResampler
    import jax
    fs, tone = 2.4e6, 1000.0
    src = os.path.join(WORK, "wbfm.iq")
    synth(src, int(fs * seconds), fs, [(0.0, tone, 60000.0, 0.63)], seed + 1)
    out = os.path.join(WORK, "wbfm.raw")
    walls = run_cli_twice(["-i", src, "-o", out, "--wbfm", "--iq-rate",
                           "2400000", "--audio-rate", "48000", "--deviation",
                           "75000", "--deemphasis", "75"])
    got = np.fromfile(out, np.float32)
    pipe = WbfmPipeline(WbfmConfig())          # the CLI's GPU geometry
    nb = int(fs * seconds) // pipe.block_complex
    if got.size != nb * pipe.audio_per_block:
        raise AssertionError(f"wbfm: {got.size} samples")
    ref = WbfmPipeline(WbfmConfig(block_seconds=pipe.cfg
                                  .resolved_block_seconds()))
    ref.chan = PolyResampler(ref.chan.L, ref.chan.M, ref.chan._hp,
                             precision=jax.lax.Precision.HIGHEST)
    raw = np.memmap(src, np.uint16, "r")
    st = _on_cpu(ref.init_state)
    want = []
    for b in range(2):
        u16 = np.asarray(raw[b * ref.block_complex:(b + 1) * ref.block_complex])
        st, a = _on_cpu(ref.call_u16, st, u16)
        want.append(np.asarray(a))
    want = np.concatenate(want)
    s = snr_db(want, got[: want.size])
    rep.phase("wbfm", walls, int(fs * seconds),
              check("snr_vs_cpu_highest_db[2 blocks]", s, BARS["wbfm"]),
              check_tone(got[pipe.audio_per_block:], 48000.0, tone))


def _bank_phase(rep: Report, name: str, fs: float, offsets, tones,
                seconds: float, seed: int, method: str):
    from demodulator_tpu.models.channel_bank import (ChannelBankConfig,
                                                     ChannelBankPipeline)
    from demodulator_tpu.ops.resample import PolyResampler
    import jax
    src = os.path.join(WORK, f"{name}.iq")
    n = int(fs * seconds)
    live = [(o, t) for o, t in zip(offsets, tones) if t]
    synth(src, n, fs, [(o, t, 5000.0, 0.8 / len(live)) for o, t in live],
          seed)
    out = os.path.join(WORK, name)
    walls = run_cli_twice(["-i", src, "-o", out, "-l", "12500", "--bank",
                           ",".join(f"{o:.0f}" for o in offsets),
                           "--iq-rate", f"{fs:.0f}", "--channel-rate",
                           "192000"])
    cfg = ChannelBankConfig(sample_rate=fs, channel_rate=192000.0,
                            offsets_hz=tuple(offsets))
    pipe = ChannelBankPipeline(cfg)
    if pipe.method != method:
        raise AssertionError(f"{name}: method {pipe.method}, want {method}")
    ref = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=fs, channel_rate=192000.0, offsets_hz=tuple(offsets),
        block_seconds=cfg.resolved_block_seconds()))
    hi = jax.lax.Precision.HIGHEST
    if method == "pfb":
        ref.pfb.precision = hi
    else:
        ref.chan = PolyResampler(1, ref.chan.M, ref.chan._hp, precision=hi)
    raw = np.memmap(src, np.uint16, "r")
    st = _on_cpu(ref.init_state)
    want = []
    for b in range(2):
        u16 = np.asarray(raw[b * ref.block_complex:(b + 1) * ref.block_complex])
        st, a = _on_cpu(ref.call_u16, st, u16)
        want.append(np.asarray(a))
    want = np.concatenate(want, axis=-1)               # [C, 2·A]
    nb = n // pipe.block_complex
    snrs, tone_checks = [], []
    for c, tone in enumerate(tones):
        got = np.fromfile(f"{out}.ch{c}.raw", np.float32)
        if got.size != nb * pipe.audio_per_block:
            raise AssertionError(f"{name} ch{c}: {got.size} samples")
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{name} ch{c}: non-finite audio")
        if tone:
            snrs.append(snr_db(want[c], got[: want.shape[-1]]))
            tone_checks.append(check_tone(got[pipe.audio_per_block:],
                                          96000.0, tone))
    rep.phase(name, walls, n,
              check(f"min_snr_vs_cpu_highest_db[{len(snrs)} stations, "
                    "2 blocks]", min(snrs), BARS[name]),
              f"{len(tone_checks)} channel tones ok: " + tone_checks[0])


def bank_phases(rep: Report, seed: int, scale: float = 1.0):
    # 64 on-grid channels at 12.288 Msps (k·fs/64): PFB; every 8th carries
    # a tone, the rest only noise
    C = 64
    offs = [(k - C // 2) * 192000.0 for k in range(C)]
    tones = [1000.0 * (1 + k // 8) if k % 8 == 3 else 0.0 for k in range(C)]
    _bank_phase(rep, "bank_pfb64", 12.288e6, offs, tones, 10.0 * scale,
                seed + 2, "pfb")
    # 8 channels off the grid (half-channel offsets) at 1.536 Msps: mixer
    offs = [(c - 4 + 0.5) * 192000.0 for c in range(8)]
    tones = [500.0 * (c + 1) for c in range(8)]
    _bank_phase(rep, "bank_mixer8", 1.536e6, offs, tones, 60.0 * scale,
                seed + 3, "mixer")


# ----------------------------------------------------------- four cards
def _cmp_bytes(a: str, b: str) -> str:
    x, y = open(a, "rb").read(), open(b, "rb").read()
    if len(x) != len(y) or x != y:
        raise AssertionError(f"{a} and {b} differ")
    return f"byte_equal {len(x)} bytes"


def _cmp_close(a, b, rtol, atol, dtype=np.float32) -> str:
    x, y = np.fromfile(a, dtype), np.fromfile(b, dtype)
    if x.shape != y.shape:
        raise AssertionError(f"{a}: {x.shape} vs {y.shape}")
    err = float(np.max(np.abs(x - y) - rtol * np.abs(y)))
    return check("max(|d|-rtol|ref|)", err, atol, higher=False) + \
        f", snr {snr_db(y, x):.1f} dB"


def multi_card_phases(rep: Report, seed: int):
    fs, nb = 192000.0, 256
    src = os.path.join(WORK, "nbfm4.iq")
    synth(src, nb * BLOCK // 2, fs, [(0.0, 1000.0, 2500.0, 0.63)], seed)
    n_iq = nb * BLOCK // 2
    base = ["-i", src, "-S", "96000", "-l", "12500"]
    for name, extra, cmp in [
            ("shard_time4_q0", [], lambda a, b: _cmp_bytes(a, b)),
            ("shard_time4_q1", ["-q", "1"],
             lambda a, b: check("snr_db", snr_db(np.fromfile(b, np.float32),
                                                 np.fromfile(a, np.float32)),
                                70.0)),
            ("shard_time4_continuous", ["--profile", "continuous"],
             lambda a, b: _cmp_close(a, b, 1e-4, 2e-6))]:
        one, four = (os.path.join(WORK, f"{name}.{k}.raw") for k in (1, 4))
        run_cli([*base, *extra, "-o", one])
        walls = run_cli_twice([*base, *extra, "-o", four, "--shard-time",
                               "4"])
        rep.phase(name, walls, n_iq, cmp(four, one))

    for name, fs_b, offs in [
            ("shard_chan4_pfb", 1.536e6,
             [(c - 4) * 192000.0 for c in range(8)]),
            ("shard_chan4_mixer", 1.536e6,
             [(c - 4 + 0.5) * 192000.0 for c in range(8)])]:
        n = int(fs_b * 10)
        bsrc = os.path.join(WORK, f"{name}.iq")
        synth(bsrc, n, fs_b, [(o, 500.0 * (c + 1), 5000.0, 0.1)
                              for c, o in enumerate(offs)], seed + 5)
        args = ["-i", bsrc, "-l", "12500", "--bank",
                ",".join(f"{o:.0f}" for o in offs),
                "--iq-rate", f"{fs_b:.0f}", "--channel-rate", "192000"]
        one, four = (os.path.join(WORK, f"{name}.{k}") for k in (1, 4))
        run_cli([*args, "-o", one])
        walls = run_cli_twice([*args, "-o", four, "--shard-chan", "4"])
        res = [_cmp_close(f"{four}.ch{c}.raw", f"{one}.ch{c}.raw", 0.0, 1e-4)
               for c in range(len(offs))]
        rep.phase(name, walls, n, f"{len(res)} channels " + res[0])

    fs_w, seconds = 2.4e6, 10
    paths = []
    for c in range(4):
        p = os.path.join(WORK, f"station{c}.iq")
        synth(p, int(fs_w * seconds), fs_w,
              [(0.0, 1000.0 * (c + 1), 60000.0, 0.63)], seed + 10 + c)
        paths.append(p)
    args = ["-o", None, "-S", "96000", "-l", "12500", "--wbfm",
            "--inputs", ",".join(paths)]
    one, four = (os.path.join(WORK, f"stations.{k}") for k in (1, 4))
    run_cli([a if a is not None else one for a in args])
    walls = run_cli_twice([a if a is not None else four for a in args]
                          + ["--shard-chan", "4"])
    res = [_cmp_close(f"{four}.st{c}.raw", f"{one}.st{c}.raw", 1e-5, 1e-5)
           for c in range(4)]
    rep.phase("wbfm_stations4_chan", walls, 4 * int(fs_w * seconds),
              "4 stations " + res[0])


# ----------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from demodulator_tpu.utils.device import card_lines, require_gpu
    devs = require_gpu()
    if len(devs) < args.cards:
        raise RuntimeError(f"{len(devs)} GPUs, --cards {args.cards}")
    cards = card_lines()
    print("cards: " + " | ".join(cards), flush=True)
    from demodulator_tpu.runtime import native
    print("block reader: " + ("native (runtime/native)" if native.available()
                              else "python (no g++ build)"), flush=True)
    rep = Report(" | ".join(cards))
    os.makedirs(WORK, exist_ok=True)
    try:
        if args.cards == 1:
            nbfm_phases(rep, args.seed)
            wbfm_phase(rep, args.seed)
            bank_phases(rep, args.seed)
        else:
            multi_card_phases(rep, args.seed)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
