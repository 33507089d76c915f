#!/usr/bin/env python3
"""Scaling-efficiency bench: weak scaling of the sharded demod step.

The reference scales only across compilers/ISAs (test.sh:83-86, qemu cross
runs); this framework's scaling story is the device mesh (SURVEY.md §2.10).
This harness measures weak-scaling efficiency over the `time` (or `chan`)
mesh axis: each device count d processes `--blocks-per-device` 256 KiB
blocks per device, and efficiency is thr(d) / (d · thr(1)) — the
BASELINE.md target is ≥85% at full-slice counts.

On a multi-GPU host this measures NVLink-attached cards; on CPU pass
`--virtual 8` to validate the harness and the sharded code path on a
virtual device mesh (numbers are then illustrative, not hardware claims).

    python tools/bench_scaling.py [--virtual 8] [--blocks-per-device 16]
        [--repeats 5] [--axis time|chan] [--q 0..3] [--profile compat]

Prints one JSON line per device count:
    {"devices": d, "msps": ..., "efficiency": ..., ...}
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _parse_stream_done(stderr_text: str) -> float:
    """msps_complex from the final stream_done metrics line."""
    msps = None
    for line in stderr_text.splitlines():
        if '"stream_done"' in line:
            msps = json.loads(line)["msps_complex"]
    if msps is None:
        raise RuntimeError("no stream_done metrics line in:\n"
                           + stderr_text[-2000:])
    return float(msps)


def _procs_mode(args) -> int:
    """N-process vs single-process e2e CLI throughput at the same total
    device count (VERDICT r2 next #4 done criterion).  Uses the process-0
    stream_done metrics (starts at pipeline construction: excludes
    interpreter/backend startup, includes compile — each config runs twice
    so the second run rides the persistent jit cache).  The `time` mesh
    axis shards blocks; --shared-out removes the output gather entirely.

    This mode runs on virtual CPU devices only (JAX_PLATFORMS=cpu in every
    child): on a GPU host each of the N processes would open, and reserve
    most of the memory of, every card."""
    import socket
    import subprocess
    import tempfile

    import numpy as np

    total = args.procs * args.procs_devs
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, args.procs_blocks * 262144, dtype=np.uint8)

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"

    with tempfile.TemporaryDirectory(prefix="benchprocs", dir="/tmp") as d:
        src = os.path.join(d, "iq.dat")
        data.tofile(src)
        cli = [sys.executable, "-m", "demodulator_tpu", "-i", src,
               "-S", "192000", "-l", "12500", "--shard-time", str(total),
               "--metrics"]

        def run_single():
            env = dict(base_env)
            env["XLA_FLAGS"] = \
                f"--xla_force_host_platform_device_count={total}"
            r = subprocess.run(
                cli + ["-o", os.path.join(d, "single.raw")],
                capture_output=True, env=env, cwd=REPO)
            if r.returncode != 0:
                raise RuntimeError(r.stderr.decode()[-3000:])
            return _parse_stream_done(r.stderr.decode())

        def run_multi():
            port = free_port()
            procs = []
            for p in range(args.procs):
                env = dict(base_env)
                env.update(
                    XLA_FLAGS="--xla_force_host_platform_device_count="
                              f"{args.procs_devs}",
                    DEMODULATOR_TPU_COORDINATOR=f"localhost:{port}",
                    DEMODULATOR_TPU_NUM_PROCESSES=str(args.procs),
                    DEMODULATOR_TPU_PROCESS_ID=str(p))
                procs.append(subprocess.Popen(
                    cli + ["-o", os.path.join(d, "multi.raw"),
                           "--distributed", "--shared-out"],
                    env=env, cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE))
            errs = []
            for p, proc in enumerate(procs):
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    for q in procs:
                        q.kill()
                    raise RuntimeError(f"worker {p}:\n"
                                       + err.decode()[-3000:])
                errs.append(err.decode())
            return _parse_stream_done(errs[0])

        run_single()                      # cold: fill the jit cache
        msps_1 = run_single()
        run_multi()
        msps_n = run_multi()

    print(json.dumps({
        "procs": args.procs, "devices_per_proc": args.procs_devs,
        "total_devices": total, "blocks": args.procs_blocks,
        "backend": "cpu-virtual",
        "msps_e2e_single_proc": round(msps_1, 1),
        "msps_e2e_multi_proc": round(msps_n, 1),
        "multi_frac_of_single": round(msps_n / msps_1, 3),
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (harness validation)")
    ap.add_argument("--blocks-per-device", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--axis", choices=("time", "chan"), default="time")
    ap.add_argument("--q", type=int, default=0, choices=range(4),
                    help="conditioning mode (reference -q)")
    ap.add_argument("--profile", choices=("compat", "continuous"),
                    default="compat")
    ap.add_argument("--fast-atan2", action="store_true", default=True)
    ap.add_argument("--e2e", action="store_true",
                    help="also measure end-to-end file→device→file wall "
                         "clock through ShardedStreamProcessor (host feed "
                         "included; time axis only) and report both numbers")
    ap.add_argument("--diagnose", action="store_true",
                    help="per device count, also measure (a) the same "
                         "total work on ONE device — the shared-core "
                         "ceiling on virtual meshes; sharded_frac_of_1dev "
                         "isolates sharding overhead from core contention "
                         "— and (b) the fixed per-step dispatch cost on "
                         "one block per shard")
    ap.add_argument("--e2e-chunks", type=int, default=6,
                    help="chunks of NB blocks in the e2e input file")
    ap.add_argument("--procs", type=int, default=0,
                    help="multi-process e2e comparison: run the CLI "
                         "single-process on procs×procs-devs virtual "
                         "devices, then procs OS processes × procs-devs "
                         "devices (--distributed --shared-out), and report "
                         "both process-0 stream_done throughputs and their "
                         "ratio (the multi-host pipelining target is the "
                         "2-process run within ~20%% of single-process)")
    ap.add_argument("--procs-devs", type=int, default=2,
                    help="virtual devices per process in --procs mode")
    ap.add_argument("--procs-blocks", type=int, default=192,
                    help="256 KiB input blocks in --procs mode")
    args = ap.parse_args(argv)

    if args.procs:
        return _procs_mode(args)

    if args.virtual:
        # jax.config works any time before the first backend
        # initialization, as tests/conftest.py does
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)

    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.parallel.mesh import (make_demod_mesh, TIME_AXIS,
                                               CHAN_AXIS)
    from demodulator_tpu.parallel.sharding import ShardedPipeline

    devices = jax.devices()
    counts = []
    d = 1
    while d <= len(devices):
        counts.append(d)
        d *= 2
    if counts[-1] != len(devices):
        counts.append(len(devices))

    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      mode=0x10 | (args.q << 2), profile=args.profile)
    n = cfg.buf_size
    rng = np.random.default_rng(0)
    base = None
    for d in counts:
        mesh = make_demod_mesh(devices=devices[:d]) if args.axis == "time" \
            else make_demod_mesh(n_time=1, n_chan=d, devices=devices[:d])
        sp = ShardedPipeline(cfg, mesh, fast_atan2=args.fast_atan2)
        nb = args.blocks_per_device * (d if args.axis == "time" else 1)
        nc = d if args.axis == "chan" else 1
        raw_np = rng.integers(0, 256, size=(nc, nb, n), dtype=np.uint8)
        spec = P(None, TIME_AXIS, None) if args.axis == "time" \
            else P(CHAN_AXIS, None, None)
        raw = jax.device_put(raw_np, NamedSharding(mesh, spec))
        off0 = jax.device_put(
            np.zeros((nc, 2), np.float32),
            NamedSharding(mesh, P(CHAN_AXIS if args.axis == "chan" else None,
                                  None)))
        # warmup (compile)
        off, audio = sp(off0, raw)
        jax.block_until_ready(audio)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            off, audio = sp(off0, raw)
            jax.block_until_ready(audio)
            best = min(best, time.perf_counter() - t0)
        samples = nc * nb * n / 2  # complex IQ samples in
        msps = samples / best / 1e6
        if base is None:
            base = msps
        eff = msps / (base * d)
        line = {
            "devices": d, "axis": args.axis, "q": args.q,
            "profile": args.profile, "blocks": nc * nb,
            "msps": round(msps, 1), "efficiency": round(eff, 4),
            "backend": jax.default_backend(),
        }
        if args.diagnose:
            # (a) shared-core ceiling: the SAME total work on ONE device
            # (unsharded).  On a virtual CPU mesh every device shares one
            # host's cores, so thr(d devices) can never exceed this; the
            # ratio `sharded_frac_of_1dev` therefore isolates the sharded
            # step's own overhead (partitioning, collectives, per-shard
            # dispatch) from core contention — it is the number that
            # transfers to real NVLink-attached cards, where the per-device
            # `efficiency` column is the hardware claim instead.
            from demodulator_tpu.models.nbfm import BlockPipeline
            pipe1 = BlockPipeline(cfg, fast_atan2=args.fast_atan2)
            flat = raw_np.reshape(nc * nb, n)
            st1 = pipe1.init_state()
            fn1 = jax.jit(pipe1.process_blocks)
            dev0 = devices[0]
            flat_d = jax.device_put(flat, dev0)
            st1 = jax.device_put(st1, dev0)
            out1 = fn1(st1, flat_d)
            jax.block_until_ready(out1)
            best1 = float("inf")
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                out1 = fn1(st1, flat_d)
                jax.block_until_ready(out1)
                best1 = min(best1, time.perf_counter() - t0)
            msps1 = samples / best1 / 1e6
            # (b) fixed per-step cost: the sharded step on ONE block per
            # shard — at this size the wall time is dominated by dispatch
            # + partition overhead, not data
            tiny_np = raw_np[:, : (d if args.axis == "time" else 1)]
            tiny = jax.device_put(tiny_np, NamedSharding(mesh, spec))
            o2, a2 = sp(off0, tiny)
            jax.block_until_ready(a2)
            best_t = float("inf")
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                o2, a2 = sp(off0, tiny)
                jax.block_until_ready(a2)
                best_t = min(best_t, time.perf_counter() - t0)
            line["msps_same_work_1dev"] = round(msps1, 1)
            line["sharded_frac_of_1dev"] = round(msps / msps1, 3)
            line["step_fixed_ms"] = round(best_t * 1e3, 2)
        if args.e2e and args.axis == "time":
            # end-to-end: the whole streaming path (ChunkReader on tmpfs →
            # sharded device step → /dev/null write), so host-feed
            # bandwidth is part of the measurement — the gap vs `msps`
            # above IS the host-feed cost (VERDICT r1 weak #2)
            import tempfile
            from demodulator_tpu.runtime.stream import ShardedStreamProcessor
            sp2 = ShardedStreamProcessor(
                cfg, mesh=mesh, fast_atan2=args.fast_atan2,
                blocks_per_shard=args.blocks_per_device)
            nb_total = sp2.NB * args.e2e_chunks
            data = rng.integers(0, 256, size=nb_total * n,
                                dtype=np.uint8).tobytes()
            tmpdir = "/dev/shm" if os.path.isdir("/dev/shm") else None
            path = None
            try:
                with tempfile.NamedTemporaryFile(dir=tmpdir,
                                                 delete=False) as f:
                    path = f.name
                    f.write(data)
                with open(os.devnull, "wb") as devnull:
                    with open(path, "rb") as fin:   # warmup / compile
                        sp2.run(fin, devnull)
                    best_e = float("inf")
                    for _ in range(max(1, args.repeats // 2)):
                        with open(path, "rb") as fin:
                            t0 = time.perf_counter()
                            sp2.run(fin, devnull)
                            best_e = min(best_e, time.perf_counter() - t0)
            finally:
                if path is not None:
                    os.unlink(path)
            msps_e = nb_total * n / 2 / best_e / 1e6
            line["msps_e2e"] = round(msps_e, 1)
            line["e2e_frac_of_device"] = round(msps_e / msps, 3)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
