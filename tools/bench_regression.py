#!/usr/bin/env python3
"""Timed-run regression matrix over the CLI.

The framework's equivalent of the reference's 3× repeated `time demodulator`
matrix over option sets (test.sh:57-59,94-125; oldTest.sh:53-55,107-165):
runs the real CLI end-to-end (file in → file out, includes compile-or-cache,
host IO, device transfer) ``--repeats`` times per config after
``--warmup`` unrecorded runs, and reports wall times, the median and the
effective Msps as one JSON line per config.  Each run is its own process
and this script never imports JAX, so every run has the card to itself.

    python tools/bench_regression.py [--blocks 64] [--repeats 3]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    # name → CLI args (BASELINE.json config shapes).  "{d}" expands to the
    # run's temp dir.
    "nbfm": ["-S", "96000", "-l", "12500"],
    "nbfm_fast": ["-S", "96000", "-l", "12500", "--fast-atan2"],
    "nbfm_inlpf": ["-S", "96000", "-L", "12500", "-l", "6500"],
    "nbfm_q2l": ["-S", "96000", "-L", "12500", "-l", "6500", "-q", "2"],
    "nbfm_cheby": ["-S", "96000", "-l", "6500", "-m", "1", "-e", "2"],
    "nbfm_correctiq": ["-S", "96000", "-l", "12500", "-q", "1"],
    "nbfm_checkpointed": ["-S", "96000", "-l", "12500",
                          "--checkpoint", "{d}/ck.npz",
                          "--checkpoint-every", "64"],
    # extension chain: 4-channel bank (PFB, on-grid) — catches regressions
    # in the channelizer/bank path the NBFM configs never touch
    "bank4": ["-S", "96000", "-l", "12500", "--bank",
              "-384000,-192000,0,192000", "--iq-rate", "768000",
              "--channel-rate", "192000"],
    # broadcast WBFM receiver chain (resampler + de-emphasis): the other
    # extension path with no NBFM overlap
    "wbfm": ["-S", "96000", "-l", "12500", "--wbfm",
             "--iq-rate", "2400000", "--audio-rate", "48000"],
}


def run_once(src: str, dst: str, args: list[str]) -> tuple[float, dict]:
    """One timed CLI run → (wall seconds, phase dict)."""
    env = dict(os.environ, DEMODULATOR_TPU_PHASES="1")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "demodulator_tpu", "-i", src, "-o", dst,
         *args], cwd=REPO, capture_output=True, env=env)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(r.stderr.decode()[-2000:])
    phases = {}
    for line in r.stderr.decode().splitlines():
        if line.startswith("PHASES "):
            phases = json.loads(line[len("PHASES "):])
    return dt, phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=64,
                    help="256 KiB blocks of random IQ per run")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1,
                    help="unrecorded cache-priming runs per config (the "
                    "reference times a warm binary; this times a warm "
                    "compile + AOT-executable cache)")
    ap.add_argument("--configs", default="all",
                    help="comma list of config names, or 'all'")
    args = ap.parse_args(argv)

    names = list(CONFIGS) if args.configs == "all" \
        else args.configs.split(",")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, args.blocks * 262144, dtype=np.uint8)
    complex_in = data.size // 2

    # NOTE: no '-' anywhere in the temp paths (reference strstr quirk)
    with tempfile.TemporaryDirectory(prefix="benchreg", dir="/tmp") as d:
        src = os.path.join(d, "iq.dat")
        data.tofile(src)
        for name in names:
            dst = os.path.join(d, f"{name}.raw")
            cfg_args = [a.replace("{d}", d) for a in CONFIGS[name]]
            for _ in range(args.warmup):
                run_once(src, dst, cfg_args)
            runs = [run_once(src, dst, cfg_args)
                    for _ in range(args.repeats)]
            walls = [w for w, _ in runs]
            print(json.dumps({
                "config": name,
                "runs": [round(w, 3) for w in walls],
                "median_s": round(statistics.median(walls), 3),
                "best_msps_complex_e2e": round(
                    complex_in / min(walls) / 1e6, 2),
                "stream_s": [p.get("stream_s") for _, p in runs],
                "first_output_s": [p.get("first_output_s") for _, p in runs],
                "aot_hit": [p.get("aot_hit") for _, p in runs],
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
