"""Throughput benchmark: flagship NBFM demod chain, one GPU.

Default invocation prints ONE JSON line: IQ complex Msamples/s through the
full per-block pipeline (uint8 conditioning → quadrature discriminator →
audio FIR) on device-resident data.

``--matrix`` additionally benchmarks every hot configuration — q0-q3, the
-L / -q2 chains, float64, WBFM, the channel banks, and the sharded step —
printing one JSON line per config with a roofline note (achieved fraction
of the minimum-HBM-traffic floor at the card's published bandwidth).  The
reference's analog is the test.sh config×compiler timing matrix
(/root/reference/test.sh:94-125).

Every row names the device (platform, device_kind, count) and the card's
name and power limit as nvidia-smi reports them.  The benchmark refuses to
run on anything but a GPU.

Methodology: the step runs N times inside ONE on-device lax.fori_loop, and
two loop lengths cancel the fixed dispatch latency.  The loop carries a true
data dependency without any buffer copies by feeding each iteration's audio
output back as the next iteration's raw input via a free bitcast (f32 →
u8); stateful pipelines (WBFM, bank) instead chain their carry state, with
the input dynamic-sliced by the loop index so XLA cannot hoist the
computation.  vs_baseline is the ratio to the reference's demonstrated
real-time rate (192 ksps complex sustained through its decode pipelines —
the only performance fact it exhibits; BASELINE.md).
"""
import argparse
import json
import time

import numpy as np

# Published HBM bandwidth by JAX device_kind, bytes/s (NVIDIA H100 data
# sheet, dense rates).  The roofline floor of a chain is its minimum in+out
# bytes over this peak; a device missing from the table is an error.
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def hbm_peak(device_kind: str) -> float:
    """Published HBM bytes/s of ``device_kind``; KeyError if unknown."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no published HBM peak for device {device_kind!r}"
                       " in bench.HBM_PEAK_BYTES_PER_S") from None


def device_record() -> dict:
    """The device every row names: JAX's view plus nvidia-smi's."""
    from demodulator_tpu.utils.device import card_lines, require_gpu
    devs = require_gpu()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_lines()}


def _timed_loop(body, carry0, n_lo=10, n_hi=70, reps=4):
    """Seconds per body() application, measured as the slope between two
    on-device fori_loop lengths (min over repeats: host noise is additive
    and positive)."""
    import jax
    import jax.numpy as jnp
    fns = {}

    def timed(N):
        if N not in fns:
            @jax.jit
            def bench(c):
                c = jax.lax.fori_loop(0, N, body, c)
                # consume EVERY carry leaf: XLA deletes dead while-loop
                # tuple elements, so returning only one leaf lets the
                # whole DSP chain of the others be dead-code-eliminated
                # (state-carried pipelines then read several times too
                # fast)
                tot = jnp.float32(0)
                for leaf in jax.tree.leaves(c):
                    tot += leaf.astype(jnp.float32).sum()
                return tot
            float(bench(carry0))  # compile + warmup
            fns[N] = bench
        t0 = time.perf_counter()
        float(fns[N](carry0))
        return time.perf_counter() - t0

    t_lo = min(timed(n_lo) for _ in range(reps))
    t_hi = min(timed(n_hi) for _ in range(reps))
    dt = (t_hi - t_lo) / (n_hi - n_lo)
    if dt <= 0:  # pathological hiccup: fall back to the long run alone
        dt = t_hi / n_hi
    return dt


def _audio_to_u8(audio, B, n):
    import jax
    import jax.numpy as jnp
    u8 = jax.lax.bitcast_convert_type(audio, jnp.uint8)
    return u8.reshape(B, -1)[:, :n]


# ---------------------------------------------------------------------------
# config builders: each returns (body, carry0, iq_complex_per_step,
#                                 min_traffic_bytes)
# ---------------------------------------------------------------------------

def _flagship(fast_atan2, q=0, B=256):
    """q0/q3 chain: the audio bytes feed back as the next raw input."""
    import jax
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.models.nbfm import BlockPipeline
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      mode=0x10 | (q << 2))
    pipe = BlockPipeline(cfg, fast_atan2=fast_atan2)
    n = cfg.buf_size
    rng = np.random.default_rng(0)
    raw = jax.device_put(rng.integers(0, 256, size=(B, n), dtype=np.uint8))
    state = pipe.init_state()

    def body(i, x):
        audio = pipe(state, x)[1]
        return _audio_to_u8(audio, B, n)
    return body, raw, B * n // 2, 2 * B * n


def _inlpf(q=0, lowpass_in=True, B=256):
    """-L / -q2 / combined -q2 -L chains (one or two complex FIR stages
    between conditioning and the discriminator)."""
    import jax
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.models.nbfm import BlockPipeline
    kw = dict(sample_rate=192000.0, lowpass_out=12500.0,
              mode=0x10 | (q << 2))
    if lowpass_in:
        kw.update(lowpass_in=12500.0)
    cfg = DemodConfig(**kw)
    pipe = BlockPipeline(cfg, fast_atan2=True)
    n = cfg.buf_size
    rng = np.random.default_rng(1)
    raw = jax.device_put(rng.integers(0, 256, size=(B, n), dtype=np.uint8))
    state = pipe.init_state()

    def body(i, x):
        audio = pipe(state, x)[1]
        return _audio_to_u8(audio, B, n)
    return body, raw, B * n // 2, 2 * B * n


def _q1(B=256):
    """correctIq: the blocked affine prefix over the block axis
    (BlockPipeline.process_blocks)."""
    import jax
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.models.nbfm import BlockPipeline
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      mode=0x10 | (1 << 2))
    pipe = BlockPipeline(cfg, fast_atan2=True)
    n = cfg.buf_size
    rng = np.random.default_rng(2)
    raw = jax.device_put(rng.integers(0, 256, size=(B, n), dtype=np.uint8))
    st0 = pipe.init_state()

    def body(i, carry):
        st, x = carry
        st, audio = pipe.process_blocks(st, x)
        return st, _audio_to_u8(audio, B, n)
    return body, (st0, raw), B * n // 2, 2 * B * n


def _f64(B=64):
    """float64 chain (-DSET_PRECISION analog): XLA path, f64 audio out."""
    import jax
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.models.nbfm import BlockPipeline
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0,
                      precision="float64")
    pipe = BlockPipeline(cfg)
    n = cfg.buf_size
    rng = np.random.default_rng(3)
    raw = jax.device_put(rng.integers(0, 256, size=(B, n), dtype=np.uint8))
    state = pipe.init_state()

    def body(i, x):
        import jax.numpy as jnp
        audio = pipe(state, x)[1]          # [B, n/4] f64 = 2n bytes
        # demote before the bitcast: the first n bytes of the f32 audio
        # feed back as the next raw input
        return _audio_to_u8(audio.astype(jnp.float32), B, n)
    return body, raw, B * n // 2, 3 * B * n  # n in + 2n out


def _wbfm():
    """WBFM broadcast chain at 2.4 Msps: state-chained loop (the overlap
    histories keep the whole audio path live), input dynamic-sliced by the
    loop index so nothing hoists."""
    import jax
    import jax.numpy as jnp
    from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
    pipe = WbfmPipeline(WbfmConfig())
    T = pipe.block_complex
    rng = np.random.default_rng(4)
    base = jax.device_put(rng.integers(0, 1 << 16, size=2 * T,
                                       dtype=np.uint16))
    st0 = pipe.init_state()

    def body(i, carry):
        st, acc = carry
        x = jax.lax.dynamic_slice(base, ((i * 997) % T,), (T,))
        st, audio = pipe.call_u16(st, x)
        # accumulate the audio: a state-only carry lets XLA dead-code the
        # audio chain beyond what the histories need (_timed_loop note)
        return st, acc + audio.sum()
    out_bytes = 4 * (T * pipe.chan.L // pipe.chan.M
                     if hasattr(pipe, "chan") else T)
    return body, (st0, jnp.float32(0)), T, 2 * T + out_bytes


def _bank(n_chan=8, on_grid=False):
    """Polyphase channel bank: n_chan NBFM channels from one wide stream.
    Fed as the u16 view (one u16 per complex sample), matching the CLI's
    zero-copy host view.
    on_grid=False: half-channel offsets → the arbitrary-offset mixer path;
    on_grid=True: k·fs/C offsets → the polyphase-FFT filterbank path."""
    import jax
    import jax.numpy as jnp
    from demodulator_tpu.models.channel_bank import (ChannelBankConfig,
                                                     ChannelBankPipeline)
    fs = n_chan * 192000.0
    half = 0.0 if on_grid else 0.5
    offs = tuple((c - n_chan / 2 + half) * 192000.0 for c in range(n_chan))
    pipe = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=fs, channel_rate=192000.0, offsets_hz=offs,
        lowpass_out=12500.0))
    assert pipe.method == ("pfb" if on_grid else "mixer"), pipe.method
    T = pipe.block_complex
    rng = np.random.default_rng(5)
    base = jax.device_put(rng.integers(0, 1 << 16, size=2 * T,
                                       dtype=np.uint16))
    st0 = pipe.init_state()

    def body(i, carry):
        st, acc = carry
        x = jax.lax.dynamic_slice(base, ((i * 997) % T,), (T,))
        st, audio = pipe.call_u16(st, x)
        return st, acc + audio.sum()   # keep the audio chain live
    return body, (st0, jnp.float32(0)), T, \
        2 * T + n_chan * (T // (fs // 96000.0) * 4)


def _sharded(B_per=2):
    """One sharded step on the available mesh (one card: exercises the
    shard_map overhead; scaling itself is tools/bench_scaling.py)."""
    import jax
    import jax.numpy as jnp
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.parallel.mesh import make_demod_mesh
    from demodulator_tpu.parallel.sharding import ShardedPipeline
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_demod_mesh()
    n_t = mesh.devices.shape[0]
    NB = n_t * B_per * 64
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0)
    n = cfg.buf_size
    sp = ShardedPipeline(cfg, mesh, fast_atan2=True)
    rng = np.random.default_rng(6)
    raw_np = rng.integers(0, 256, size=(1, NB, n), dtype=np.uint8)
    off = jax.device_put(np.zeros((1, 2), np.float32),
                         NamedSharding(mesh, P(None, None)))
    raw = jax.device_put(raw_np, NamedSharding(mesh, P(None, "time", None)))

    def body(i, carry):
        off, x = carry
        off, audio = sp(off, x)
        u8 = jax.lax.bitcast_convert_type(audio, jnp.uint8)
        return off, u8.reshape(1, NB, n)
    return body, (off, raw), NB * n // 2, 2 * NB * n


def _copy_floor(B=256):
    """Plain XLA copy at the flagship's input shape (read B·n bytes, write
    B·n bytes per step): the measured HBM read+write rate, reported as its
    own row and used as the denominator of each row's frac_of_copy."""
    import jax
    import jax.numpy as jnp
    n = 262144
    rng = np.random.default_rng(8)
    u32 = jax.device_put(rng.integers(0, 256, size=(B, n), dtype=np.uint8)
                         .view(np.uint32))

    def body(i, x):
        return x ^ i.astype(jnp.uint32)   # depends on i: not hoistable
    return body, u32, B * n // 2, 2 * B * n


def _measure_e2e(name, n_blocks=96, fast_atan2=True, pipeline_factory=None):
    """End-to-end file→device→file wall clock through StreamProcessor:
    the host-feed number the device-resident loops can't see (the
    reference's whole-process `time` runs, test.sh:57-59).  Input lives
    in a temporary file; output goes to /dev/null, so the measurement is
    read + device round-trip + write-path overhead.  ``pipeline_factory``
    swaps in an extension pipeline (WBFM) with its own block size."""
    import os
    import tempfile
    from demodulator_tpu.config import DemodConfig
    from demodulator_tpu.runtime.stream import StreamProcessor
    cfg = DemodConfig(sample_rate=192000.0, lowpass_out=12500.0)
    proc = StreamProcessor(cfg, fast_atan2=fast_atan2,
                           pipeline=pipeline_factory()
                           if pipeline_factory else None)
    n = proc.block_bytes
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=n_blocks * n, dtype=np.uint8).tobytes()
    with tempfile.NamedTemporaryFile(delete=False) as f:
        path = f.name
    try:  # write inside the unlinking try: no leak if the write fails
        with open(path, "wb") as f:
            f.write(data)
        with open(os.devnull, "wb") as devnull:
            with open(path, "rb") as fin:  # warmup: compile + cache
                proc.run(fin, devnull)
            best = float("inf")
            for _ in range(3):
                with open(path, "rb") as fin:
                    t0 = time.perf_counter()
                    proc.run(fin, devnull)
                    best = min(best, time.perf_counter() - t0)
    finally:
        os.unlink(path)
    msps = n_blocks * n / 2 / best / 1e6
    link = _host_link_bound(n)
    return {
        "metric": f"iq_throughput_{name}",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps * 1e6 / 192000.0, 1),
        "host_link_bound_msps": round(link, 1),
        "e2e_frac_of_link": round(msps / link, 3),
        "note": "file→device→file wall clock (host feed included). "
                "host_link_bound_msps is the serialized device_put+get "
                "round-trip limit of this host↔device link; frac>1 means "
                "the inflight window overlaps transfers beyond the serial "
                "bound.",
    }


def _measure_e2e_bank(n_blocks=12, n_chan=4):
    """End-to-end wall clock of the --bank CLI loop body: tmpfs file →
    u16 view → ChannelBankPipeline (PFB) → per-channel /dev/null writes,
    with the CLI's one-block inflight window."""
    import os
    import tempfile
    import jax
    from demodulator_tpu.models.channel_bank import (ChannelBankConfig,
                                                     ChannelBankPipeline)
    fs = n_chan * 192000.0
    offs = tuple((c - n_chan / 2) * 192000.0 for c in range(n_chan))
    pipe = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=fs, channel_rate=192000.0, offsets_hz=offs,
        lowpass_out=12500.0))
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, size=n_blocks * pipe.block_bytes,
                        dtype=np.uint8)
    fn = jax.jit(pipe.call_u16)

    def run(path, sink):
        state = pipe.init_state()
        pending = None
        with open(path, "rb") as fin:
            while True:
                raw = fin.read(pipe.block_bytes)
                if len(raw) < pipe.block_bytes:
                    break
                u16 = np.frombuffer(raw, np.uint16)
                state, audio = fn(state, u16)
                if pending is not None:
                    sink.write(np.asarray(pending).tobytes())
                pending = audio
            if pending is not None:
                sink.write(np.asarray(pending).tobytes())

    with tempfile.NamedTemporaryFile(delete=False) as f:
        path = f.name
    try:
        with open(path, "wb") as f:
            f.write(data.tobytes())
        with open(os.devnull, "wb") as devnull:
            run(path, devnull)                      # warmup / compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                run(path, devnull)
                best = min(best, time.perf_counter() - t0)
    finally:
        os.unlink(path)
    msps = n_blocks * pipe.block_bytes / 2 / best / 1e6
    return {
        "metric": "iq_throughput_e2e_bank4_pfb",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps * 1e6 / 192000.0, 1),
        "note": "4-channel PFB bank, file→device→per-channel-write wall "
                "clock (the --bank CLI loop body)",
    }


def _host_link_bound(n, reps=6):
    """Serialized per-block device round-trip limit: device_put a block's
    uint32 view, trivial jitted op, fetch the audio-sized f32 back."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    u32 = rng.integers(0, 256, size=n, dtype=np.uint8).view(
        np.uint32).reshape(1, (n // 4) // 128, 128)
    f = jax.jit(lambda x: x.astype(jnp.float32) * 1.5)
    np.asarray(f(jax.device_put(u32)))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(f(jax.device_put(u32)))
        best = min(best, time.perf_counter() - t0)
    return n / 2 / best / 1e6


MATRIX = [
    ("hbm_copy_floor", _copy_floor),
    ("nbfm_q0_precise", lambda: _flagship(False, q=0)),
    ("nbfm_q0_fast", lambda: _flagship(True, q=0)),
    ("nbfm_q3_fast", lambda: _flagship(True, q=3)),
    ("nbfm_q1_correctiq", _q1),
    ("nbfm_q2_dcblock", lambda: _inlpf(q=2, lowpass_in=False)),
    ("nbfm_inlpf", lambda: _inlpf(q=0, lowpass_in=True)),
    ("nbfm_q2_inlpf", lambda: _inlpf(q=2, lowpass_in=True)),
    ("nbfm_f64", _f64),
    ("wbfm_2p4msps", _wbfm),
    ("channel_bank_8ch", _bank),
    ("channel_bank_8ch_pfb", lambda: _bank(on_grid=True)),
    ("channel_bank_64ch_pfb", lambda: _bank(n_chan=64, on_grid=True)),
    ("sharded_step", _sharded),
]


def _measure(name, build, device, n_lo=10, n_hi=70):
    body, carry0, iq_per_step, traffic = build()
    dt = _timed_loop(body, carry0, n_lo=n_lo, n_hi=n_hi)
    msps = iq_per_step / dt / 1e6
    floor_s = traffic / hbm_peak(device["kind"])
    return {
        "metric": f"iq_throughput_{name}",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps * 1e6 / 192000.0, 1),
        "roofline": {
            "min_traffic_bytes_per_step": int(traffic),
            "hbm_floor_msps": round(iq_per_step / floor_s / 1e6, 1),
            "achieved_frac": round(floor_s / dt, 3),
        },
        "device": device,
    }


def main():
    from demodulator_tpu.cli import _enable_compile_cache
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", action="store_true",
                    help="benchmark every hot config, one JSON line each")
    ap.add_argument("--rows", default="",
                    help="comma list of matrix row names to run (default "
                    "all)")
    args = ap.parse_args()
    device = device_record()     # raises unless JAX's backend is the GPU
    _enable_compile_cache()

    flagship = _measure("nbfm_q0_fast", lambda: _flagship(True, q=0),
                        device, n_lo=20, n_hi=120)
    flagship_line = {
        "metric": "nbfm_demod_iq_throughput_per_chip",
        "value": flagship["value"],
        "unit": "Msamples/s",
        "vs_baseline": flagship["vs_baseline"],
        "device": device,
    }
    if not args.matrix:
        print(json.dumps(flagship_line))
        return

    keep_rows = set(args.rows.split(",")) if args.rows else None
    copy_msps = None
    for name, build in MATRIX:
        if keep_rows and name not in keep_rows:
            continue
        if name == "nbfm_q0_fast":
            r = flagship
        else:
            short = name in ("sharded_step", "nbfm_f64")
            r = _measure(name, build, device, n_lo=10 if short else 20,
                         n_hi=60 if short else 120)
        if name == "hbm_copy_floor":
            copy_msps = r["value"]
        if copy_msps and r["roofline"]["min_traffic_bytes_per_step"] == \
                2 * 256 * 262144:
            # fraction of the measured copy rate, for every row with the
            # flagship's traffic shape (the copy row comes first)
            r["roofline"]["frac_of_copy"] = round(r["value"] / copy_msps, 3)
        print(json.dumps(r), flush=True)

    def _wbfm_pipe():
        from demodulator_tpu.models.wbfm import WbfmConfig, WbfmPipeline
        return WbfmPipeline(WbfmConfig(sample_rate=2.4e6))

    e2e_rows = [
        ("e2e_stream_q0", dict()),
        ("e2e_stream_wbfm", dict(pipeline_factory=_wbfm_pipe, n_blocks=24)),
    ]
    for nm, kw in e2e_rows:
        if keep_rows and nm not in keep_rows:
            continue
        print(json.dumps(dict(_measure_e2e(nm, **kw), device=device)),
              flush=True)
    if not keep_rows or "e2e_bank4_pfb" in keep_rows:
        print(json.dumps(dict(_measure_e2e_bank(), device=device)),
              flush=True)
    print(json.dumps(flagship_line))


if __name__ == "__main__":
    main()
