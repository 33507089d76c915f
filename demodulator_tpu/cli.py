"""Reference-compatible command line front end.

Replicates the reference's getopt loop (src/main.c:125-183) so the README
pipelines run verbatim against this binary:

    demodulator-tpu -i file|- -o file|- [-L -l -S -D -d -e -m -b -c -q]

Quirks preserved: an -i/-o argument CONTAINING '-' selects stdin/stdout
(the reference uses strstr, src/main.c:127-142); -e is divided by 10; -r/-n
are accepted and ignored; -b shifts DEFAULT_BUF_SIZE.

Framework extensions use long options (never colliding with the reference's
short ones): --profile compat|continuous, --precision float32|float64,
--fast-atan2, --tail drop|pad, --verbose-design, --chunk-blocks N (blocks
per device dispatch on the NBFM paths, default 16; 1 = per-block), and the
WBFM broadcast receiver --wbfm [--iq-rate 2400000 --audio-rate 48000
--deviation 75000 --deemphasis 75] (rational polyphase resample +
de-emphasis; models/wbfm.py).
"""
from __future__ import annotations

import sys

from .config import DemodConfig, config_from_cli_opts

SHORT_OPTS = "i:o:r:L:l:S:D:d:e:m:b:c:q:n:"


def parse_args(argv):
    """getopt-style parse → (opts dict, extras dict).  Unknown short options
    are ignored like the reference's default case."""
    takes_arg = {SHORT_OPTS[i]: True for i in range(0, len(SHORT_OPTS), 2)}
    opts: dict = {}
    extras = {"profile": "compat", "precision": "float32", "fast_atan2": False,
              "tail": None, "verbose_design": False, "wbfm": False,
              "iq_rate": "2400000", "audio_rate": "48000",
              "deviation": "75000", "deemphasis": "75",
              "checkpoint": None, "checkpoint_every": "64", "resume": False,
              "metrics": False, "trace": None,
              "bank": None, "channel_rate": "192000", "inputs": None,
              "shard_time": None, "shard_chan": None,
              "distributed": False, "shared_out": False,
              "block_seconds": None, "chunk_blocks": "auto"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--fast-atan2":
            extras["fast_atan2"] = True
        elif a == "--verbose-design":
            extras["verbose_design"] = True
        elif a == "--wbfm":
            extras["wbfm"] = True
        elif a == "--resume":
            extras["resume"] = True
        elif a == "--metrics":
            extras["metrics"] = True
        elif a == "--distributed":
            extras["distributed"] = True
        elif a == "--shared-out":
            extras["shared_out"] = True
        elif a in ("--profile", "--precision", "--tail", "--iq-rate",
                   "--audio-rate", "--deviation", "--deemphasis",
                   "--checkpoint", "--checkpoint-every", "--trace",
                   "--bank", "--channel-rate", "--shard-time",
                   "--shard-chan", "--block-seconds",
                   "--chunk-blocks", "--inputs"):
            i += 1
            if i >= len(argv):
                raise SystemExit(f"option {a} requires an argument")
            extras[a[2:].replace("-", "_")] = argv[i]
        elif a.startswith("--"):
            raise SystemExit(f"unknown option {a}")
        elif a.startswith("-") and len(a) >= 2 and a[1] in takes_arg:
            key = a[1]
            if len(a) > 2:
                opts[key] = a[2:]
            else:
                i += 1
                if i >= len(argv):
                    raise SystemExit(f"option -{key} requires an argument")
                opts[key] = argv[i]
        # unknown single-dash options fall through silently (getopt default:)
        i += 1
    return opts, extras


def _dump_design(cfg: DemodConfig):
    """--verbose-design: print the SOS tables like the reference's VERBOSE
    build (src/filter.c:160-204) for A/B comparison."""
    import numpy as np
    from .design.biquad import design_sos
    def show(tag, mode, degree, fc):
        sos = np.asarray(design_sos(mode, degree, fc, cfg.sample_rate,
                                    cfg.epsilon, dtype=np.float64))
        print(f"\n{tag}: mode={mode} degree={degree} fc={fc} "
              f"fs={cfg.sample_rate}", file=sys.stderr)
        for row in sos:
            print(" ".join(f"{v:.6f}" for v in row), file=sys.stderr)
    show("out", cfg.out_filter_family(), cfg.out_filter_degree, cfg.lowpass_out)
    if cfg.lowpass_in:
        show("in", cfg.in_filter_family(), cfg.effective_in_filter_degree(),
             cfg.lowpass_in)


def _enable_compile_cache():
    """Persistent XLA compilation cache under runtime.aot.cache_root():
    JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself, so no
    directory is set here), else a fixed directory inside the checkout.
    Later CLI invocations then skip compilation."""
    import os
    import jax
    from .runtime.aot import cache_root
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_root())
    # write every entry: a stream compiles several sub-second jits (tail
    # blocks, state snapshots) whose recompilation would otherwise land in
    # every warm start's time to first output
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def _resolve_chunk_blocks(extras, block_bytes: int) -> int:
    """--chunk-blocks auto → ~4 MiB per device dispatch (the NBFM paths'
    target); explicit N is clamped to ≥ 1."""
    if extras["chunk_blocks"] == "auto":
        return max(1, min(256, (4 << 20) // block_bytes))
    return max(1, int(extras["chunk_blocks"]))


def _run_bank(cfg, opts, extras, fin, oarg) -> int:
    """--bank f1,f2,...: channel-bank mode (models/channel_bank.py).  The -o
    argument is a filename template; each channel writes <out>.ch<N>.raw
    (stdout is refused — N parallel streams don't interleave usefully).
    --checkpoint/--resume and --metrics work like the single-stream modes.

    Dispatch is chunked like the NBFM paths (--chunk-blocks auto ≈ 4 MiB
    per device call): NB blocks per jit via lax.scan over the block axis —
    the identical op sequence the per-block loop runs, so output is
    byte-identical — which amortizes the per-dispatch host cost (the
    reference's single uniform consumer loop, src/matrix.c:178-280, has no
    such per-call cost)."""
    import numpy as np
    from .models.channel_bank import ChannelBankConfig, ChannelBankPipeline
    from .runtime.stream import ChunkReader, _seek_or_skip
    if "-" in oarg:
        print("--bank requires a file -o (one output per channel)",
              file=sys.stderr)
        return -1
    offsets = tuple(float(v) for v in extras["bank"].split(","))
    bcfg = ChannelBankConfig(sample_rate=float(extras["iq_rate"]),
                             channel_rate=float(extras["channel_rate"]),
                             offsets_hz=offsets,
                             lowpass_out=cfg.lowpass_out,
                             out_filter_degree=cfg.out_filter_degree,
                             out_filter_family=cfg.out_filter_family(),
                             epsilon=cfg.epsilon,
                             block_seconds=float(extras["block_seconds"])
                             if extras["block_seconds"] else 0.0)
    import jax
    import jax.numpy as jnp
    pipe = ChannelBankPipeline(bcfg)
    state = pipe.init_state()
    if extras["shard_chan"]:
        # DP over the channel axis (SURVEY.md §2.10): LUTs + per-channel
        # state placed over the mesh's chan axis; the per-channel stages
        # then run SPMD with zero communication (channel_bank.shard_over)
        nc = int(extras["shard_chan"])
        if len(offsets) % nc:
            print("--shard-chan must divide the channel count",
                  file=sys.stderr)
            return -1
        from .parallel.mesh import make_demod_mesh
        mesh = make_demod_mesh(n_time=1, n_chan=nc)
        state, _ = pipe.shard_over(mesh, state)
    NB = _resolve_chunk_blocks(extras, pipe.block_bytes)
    fn1 = jax.jit(pipe.call_u16)
    scan_u16 = lambda st, u16s: jax.lax.scan(pipe.call_u16, st, u16s)
    fn_nb = jax.jit(scan_u16) if NB > 1 else None
    if not extras["shard_chan"]:
        # warm-start: serialized-executable cache (runtime/aot.py) skips
        # trace+lower+compile on repeat invocations; sharded state keeps
        # the plain jit (the executable bakes in input shardings)
        from .runtime.aot import cached_pipeline_jit
        T = pipe.block_bytes // 2
        st_struct = jax.eval_shape(pipe.init_state)
        c1, _ = cached_pipeline_jit(
            pipe.call_u16, bcfg,
            (st_struct, jax.ShapeDtypeStruct((T,), np.uint16)),
            "ChannelBank.call_u16")
        fn1 = c1 if c1 is not None else fn1
        if NB > 1:
            cn, _ = cached_pipeline_jit(
                scan_u16, bcfg,
                (st_struct, jax.ShapeDtypeStruct((NB, T), np.uint16)),
                "ChannelBank.scan.call_u16")
            fn_nb = cn if cn is not None else fn_nb
    out_dtype = cfg.np_dtype()
    blocks = 0
    byte_offset = 0
    ck = extras["checkpoint"]
    ck_every = max(1, int(extras["checkpoint_every"]))
    ck_every_chunks = max(1, ck_every // NB)
    open_mode = "wb"
    if extras["resume"]:
        if not ck:
            print("--resume requires --checkpoint", file=sys.stderr)
            return -1
        from .runtime.checkpoint import load_checkpoint
        state, byte_offset, blocks = load_checkpoint(ck, state, cfg=bcfg)
        open_mode = "ab"
    metrics = None
    if extras["metrics"]:
        from .utils.metrics import StreamMetrics
        metrics = StreamMetrics(pipe.block_bytes, pipe.block_bytes // 2)
    snap_fn = (jax.jit(lambda s: jax.tree.map(jnp.copy, s)) if ck else None)
    outs = [open(f"{oarg}.ch{c}.raw", open_mode)
            for c in range(len(offsets))]
    try:
        if byte_offset:
            _seek_or_skip(fin, byte_offset)
        reader = ChunkReader(fin, pipe.block_bytes, NB,
                             tail_policy=extras["tail"] or "drop")
        done = 0  # blocks since (re)start — byte_offset already covers
        done_chunks = 0

        def ckpt(state_h):
            from .runtime.checkpoint import save_checkpoint
            save_checkpoint(ck, jax.tree.map(np.asarray, state_h),
                            byte_offset=byte_offset
                            + done * pipe.block_bytes,
                            blocks=blocks, cfg=bcfg)

        def _write(item):
            nonlocal blocks, done, done_chunks
            dev_audio, nb, snap = item
            audio = np.asarray(dev_audio, dtype=out_dtype)  # sync here
            if audio.ndim == 2:          # per-block [C, A]
                audio = audio[None]
            for c, f in enumerate(outs):
                # [NB, A] per channel: block-sequential = channel stream
                f.write(np.ascontiguousarray(audio[:, c]).tobytes())
            blocks += nb
            done += nb
            done_chunks += 1
            if metrics is not None:
                # count at materialization (post-sync), not dispatch: with
                # the inflight window a dispatched chunk may still be
                # computing on device
                metrics.block_done(nb)
            if snap is not None:
                ckpt(snap)

        pending = None  # one-chunk inflight window: jit dispatch is async,
        # so materializing chunk c only AFTER dispatching c+1 overlaps the
        # host read + file writes with device compute (the single-stream
        # StreamProcessor's window, stream.py)
        tail_chunk = None
        dispatched = 0
        for chunk in reader:
            if len(chunk) < NB:
                tail_chunk = chunk
                break
            # zero-copy u16 view of the blocks (low byte = I): skips the
            # device-side u8→u16 bitcast relayout (models/channel_bank.py
            # call_u16 docstring)
            u16 = np.ascontiguousarray(chunk).view(np.uint16)
            if NB == 1:
                state, audio = fn1(state, u16[0])
            else:
                state, audio = fn_nb(state, u16)
            dispatched += 1
            snap = (snap_fn(state) if snap_fn is not None
                    and dispatched % ck_every_chunks == 0 else None)
            if pending is not None:
                _write(pending)
            pending = (audio, NB, snap)
        if pending is not None:
            _write(pending)
        if tail_chunk is not None:
            for raw in tail_chunk:
                u16 = np.ascontiguousarray(raw).view(np.uint16)
                state, audio = fn1(state, u16)
                _write((audio, 1, None))
        if ck:
            ckpt(state)
    finally:
        for f in outs:
            f.close()
    if metrics is not None:
        import json as _json
        print(_json.dumps(metrics.final()), file=sys.stderr)
    return 0


def _run_wbfm_bank(cfg, extras, oarg) -> int:
    """--wbfm --inputs f1,..,fC: C independent WBFM stations (one IQ file
    each, e.g. an SDR array) demodulated as ONE [C]-leading batch per
    dispatch; station c writes <out>.st<c>.raw.  --shard-chan N places
    the batch over an N-device chan mesh (models/wbfm.py shard_over —
    zero-communication DP).  Stops at the shortest input's last full
    block (streams advance in lockstep).

    Runtime-feature parity with every other CLI family (feature table:
    docs/ARCHITECTURE.md): --checkpoint/--resume (per-station byte offset
    is common — streams advance in lockstep), --metrics, and output width
    from --precision (cfg.np_dtype(), like the single-station path)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from .models.wbfm import WbfmConfig, WbfmPipeline
    from .runtime.stream import _seek_or_skip
    paths = [p for p in extras["inputs"].split(",") if p]
    C = len(paths)
    if "-" in oarg:
        print("--inputs requires a file -o (one output per station)",
              file=sys.stderr)
        return -1
    wcfg = WbfmConfig(sample_rate=float(extras["iq_rate"]),
                      audio_rate=float(extras["audio_rate"]),
                      deviation=float(extras["deviation"]),
                      deemphasis_us=float(extras["deemphasis"]),
                      block_seconds=float(extras["block_seconds"])
                      if extras["block_seconds"] else 0.0)
    pipe = WbfmPipeline(wcfg)
    state = pipe.init_state((C,))
    in_sh = None
    if extras["shard_chan"]:
        nc = int(extras["shard_chan"])
        if C % nc:
            print("--shard-chan must divide the station count",
                  file=sys.stderr)
            return -1
        from .parallel.mesh import make_demod_mesh
        mesh = make_demod_mesh(n_time=1, n_chan=nc)
        state, in_sh = pipe.shard_over(mesh, state)
    out_dtype = cfg.np_dtype()
    bb = pipe.block_bytes
    blocks = 0          # lockstep block rounds emitted (all stations)
    byte_offset = 0     # per-station consumed bytes
    ck = extras["checkpoint"]
    ck_every = max(1, int(extras["checkpoint_every"]))
    open_mode = "wb"
    if extras["resume"]:
        if not ck:
            print("--resume requires --checkpoint", file=sys.stderr)
            return -1
        from .runtime.checkpoint import load_checkpoint
        state, byte_offset, blocks = load_checkpoint(ck, state, cfg=wcfg)
        if in_sh is not None:
            state = jax.tree.map(lambda a: jax.device_put(a, in_sh), state)
        open_mode = "ab"
    metrics = None
    if extras["metrics"]:
        from .utils.metrics import StreamMetrics
        metrics = StreamMetrics(C * bb, C * (bb // 2))
    # donation consumes the incoming state buffer, so checkpoint snapshots
    # are ASYNC on-device copies dispatched before the next call (the
    # StreamProcessor pattern) and materialize only inside ckpt()
    fn = jax.jit(pipe.call_u16, donate_argnums=(0,))
    if in_sh is None:
        # warm-start executable cache (see _run_bank); sharded batches
        # keep the plain jit
        from .runtime.aot import cached_pipeline_jit
        c, _ = cached_pipeline_jit(
            pipe.call_u16, wcfg,
            (jax.eval_shape(lambda: pipe.init_state((C,))),
             jax.ShapeDtypeStruct((C, bb // 2), np.uint16)),
            "Wbfm.bank.call_u16", donate_argnums=(0,))
        fn = c if c is not None else fn
    snap_fn = (jax.jit(lambda s: jax.tree.map(jnp.copy, s)) if ck else None)
    fins = [open(p, "rb") for p in paths]
    outs = [open(f"{oarg}.st{c}.raw", open_mode) for c in range(C)]
    pending = None
    done = 0  # block rounds since (re)start

    def ckpt(state_h):
        from .runtime.checkpoint import save_checkpoint
        save_checkpoint(ck, jax.tree.map(np.asarray, state_h),
                        byte_offset=byte_offset + done * bb,
                        blocks=blocks, cfg=wcfg)

    def _write(item):
        nonlocal blocks, done
        dev_audio, snap = item
        audio = np.asarray(dev_audio, dtype=out_dtype)  # sync here
        for c, f in enumerate(outs):
            f.write(audio[c].tobytes())
        blocks += 1
        done += 1
        if metrics is not None:
            metrics.block_done()
        if snap is not None:
            ckpt(snap)

    try:
        if byte_offset:
            for f in fins:
                _seek_or_skip(f, byte_offset)
        dispatched = 0
        while True:
            chunk = np.empty((C, bb), dtype=np.uint8)
            short = False
            for c, f in enumerate(fins):
                got = f.readinto(memoryview(chunk[c]))
                while got and got < bb:
                    r = f.readinto(memoryview(chunk[c])[got:])
                    if not r:
                        break
                    got += r
                if got < bb:
                    short = True
            if short:
                break
            u16 = chunk.view(np.uint16)
            dev = jax.device_put(u16, in_sh) if in_sh is not None else u16
            state, audio = fn(state, dev)
            dispatched += 1
            snap = (snap_fn(state) if snap_fn is not None
                    and dispatched % ck_every == 0 else None)
            if pending is not None:
                _write(pending)  # one-block inflight window
            pending = (audio, snap)
        if pending is not None:
            _write(pending)
        if ck:
            ckpt(state)
    finally:
        for f in fins + outs:
            f.close()
    if metrics is not None:
        import json as _json
        print(_json.dumps(metrics.final()), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import os as _os
    import time as _time
    _phases = {} if _os.environ.get("DEMODULATOR_TPU_PHASES") else None
    _t0 = _time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return -1
    opts, extras = parse_args(argv)
    cfg = config_from_cli_opts(opts)
    cfg.profile = extras["profile"]
    cfg.precision = extras["precision"]
    cfg.validate()
    if cfg.profile == "continuous" and (extras["wbfm"] or extras["bank"]):
        print("--profile continuous applies to the NBFM stream paths only "
              "(not --wbfm/--bank)", file=sys.stderr)
        return -1

    if extras["verbose_design"]:
        _dump_design(cfg)

    # -i / -o: any argument containing '-' means stdin/stdout (strstr quirk)
    iarg, oarg = opts.get("i"), opts.get("o")
    if extras["inputs"] and iarg is None:
        iarg = extras["inputs"].split(",")[0]  # -i unused in bank modes
    if iarg is None or oarg is None:
        print("both -i and -o are required", file=sys.stderr)
        return -1
    try:
        ck_every = int(extras["checkpoint_every"])
        if ck_every < 1:
            raise ValueError
    except ValueError:
        print("--checkpoint-every requires a positive integer",
              file=sys.stderr)
        return -1
    # bank modes manage their own per-channel/per-station files — never
    # open -i (wbfm bank reads its --inputs itself) or open/truncate -o
    wbfm_bank = bool(extras["wbfm"] and extras["inputs"])
    fin = None if wbfm_bank else (
        sys.stdin.buffer if "-" in iarg else open(iarg, "rb"))
    fout = None if (extras["bank"] or wbfm_bank) else (
        sys.stdout.buffer if "-" in oarg else open(oarg, "wb"))
    if extras["distributed"]:
        if not extras["shard_time"]:
            print("--distributed requires --shard-time N (the sharded "
                  "streaming path)", file=sys.stderr)
            return -1
        # must run before ANY jax backend use (incl. the compile cache)
        from .parallel.distributed import init_distributed
        init_distributed()
    _enable_compile_cache()
    trace_ctx = None
    if extras["trace"]:
        import jax
        jax.profiler.start_trace(extras["trace"])
        trace_ctx = extras["trace"]
    try:
        from .runtime.stream import StreamProcessor
        run_kw = {"tail_policy": extras["tail"],
                  "checkpoint_path": extras["checkpoint"],
                  "checkpoint_every": ck_every,
                  "resume": extras["resume"]}
        if extras["bank"] or wbfm_bank:
            try:
                rc = (_run_wbfm_bank(cfg, extras, oarg) if wbfm_bank
                      else _run_bank(cfg, opts, extras, fin, oarg))
                if _phases is not None and rc == 0:
                    # bank families manage their own loops: total wall
                    # time only
                    import json as _json
                    _phases["total_s"] = round(
                        _time.perf_counter() - _t0, 3)
                    print("PHASES " + _json.dumps(_phases),
                          file=sys.stderr)
                return rc
            except Exception as e:
                from .runtime.checkpoint import CheckpointError
                if isinstance(e, CheckpointError):
                    print(f"checkpoint error: {e}", file=sys.stderr)
                    return -1
                raise
        if extras["shard_time"]:
            if extras["wbfm"]:
                print("--shard-time is incompatible with --wbfm "
                      "(NBFM stream only)", file=sys.stderr)
                return -1
            import os as _os
            import jax
            from .runtime.stream import ShardedStreamProcessor
            cfg.num_channels = 1
            sproc = ShardedStreamProcessor(
                cfg, n_time=int(extras["shard_time"]),
                fast_atan2=extras["fast_atan2"],
                shared_output=extras["shared_out"]
                and jax.process_count() > 1)
            if jax.process_count() > 1:
                if "-" in iarg:
                    print("--distributed ingest requires a file -i "
                          "(each host reads its own block ranges)",
                          file=sys.stderr)
                    return -1
                if extras["shared_out"]:
                    # every process pwrites its own time shards into ONE
                    # shared-filesystem output file (zero output network
                    # traffic); non-zero processes must NOT truncate it
                    if "-" in oarg:
                        print("--shared-out requires a file -o",
                              file=sys.stderr)
                        return -1
                    if jax.process_index() != 0:
                        if fout is not None:
                            fout.close()
                        ofd = _os.open(oarg, _os.O_WRONLY | _os.O_CREAT,
                                       0o644)
                        fout = _os.fdopen(ofd, "wb")
                elif jax.process_index() != 0:
                    # only process 0 writes the output stream
                    if fout is not None and fout is not sys.stdout.buffer:
                        fout.close()
                    fout = open(_os.devnull, "wb")
            smet = None
            if extras["metrics"]:
                from .utils.metrics import StreamMetrics
                smet = StreamMetrics(sproc.block_bytes,
                                     sproc.block_bytes // 2)
            sproc.run(fin, fout, tail_policy=extras["tail"], metrics=smet,
                      checkpoint_path=extras["checkpoint"],
                      checkpoint_every=ck_every, resume=extras["resume"])
            if smet is not None:
                import json as _json
                print(_json.dumps(smet.final()), file=sys.stderr)
            return 0
        if extras["wbfm"]:
            from .models.wbfm import WbfmConfig, WbfmPipeline
            wcfg = WbfmConfig(sample_rate=float(extras["iq_rate"]),
                              audio_rate=float(extras["audio_rate"]),
                              deviation=float(extras["deviation"]),
                              deemphasis_us=float(extras["deemphasis"]),
                              block_seconds=float(extras["block_seconds"])
                              if extras["block_seconds"] else 0.0)
            proc = StreamProcessor(cfg, pipeline=WbfmPipeline(wcfg),
                                   aot=True)
            run_kw["tail_policy"] = extras["tail"] or "drop"
        else:
            # target ~4 MiB per device dispatch: 16 blocks at the
            # default 256 KiB bufSize, more for small -b blocks
            nb = _resolve_chunk_blocks(extras, cfg.buf_size)
            if _phases is not None:
                # force + attribute backend init separately from
                # trace/compile (it otherwise lands in whichever jax call
                # touches the backend first)
                import jax
                _tb = _time.perf_counter()
                jax.devices()
                _phases["backend_init_s"] = round(
                    _time.perf_counter() - _tb, 3)
            proc = StreamProcessor(cfg, fast_atan2=extras["fast_atan2"],
                                   chunk_blocks=nb, aot=True)
        if extras["metrics"]:
            from .utils.metrics import StreamMetrics
            run_kw["metrics"] = StreamMetrics(proc.block_bytes,
                                              proc.block_bytes // 2)
        if _phases is not None:
            _phases["build_s"] = round(_time.perf_counter() - _t0, 3)
        try:
            proc.run(fin, fout, **run_kw)
            if _phases is not None:
                # DEMODULATOR_TPU_PHASES=1: one stderr JSON line splitting
                # wall time into build (imports+backend+filter design),
                # first output (trace+compile+first dispatch — where
                # compile-cache misses land), and steady streaming
                import json as _json
                if getattr(proc, "aot_hit", None) is not None:
                    _phases["aot_hit"] = proc.aot_hit
                    _phases["aot_s"] = round(proc.aot_s, 3)
                if getattr(proc, "first_dispatch_s", None) is not None:
                    _phases["first_dispatch_s"] = round(
                        proc.first_dispatch_s, 3)
                _phases["first_output_s"] = round(
                    getattr(proc, "first_output_s", None) or 0.0, 3)
                _phases["total_s"] = round(_time.perf_counter() - _t0, 3)
                _phases["stream_s"] = round(
                    _phases["total_s"] - _phases["build_s"]
                    - _phases["first_output_s"], 3)
                print("PHASES " + _json.dumps(_phases), file=sys.stderr)
        except Exception as e:
            from .runtime.checkpoint import CheckpointError
            if isinstance(e, CheckpointError):
                print(f"checkpoint error: {e}", file=sys.stderr)
                return -1
            raise
        if extras["metrics"]:
            import json as _json
            print(_json.dumps(run_kw["metrics"].final()), file=sys.stderr)
    except BlockingIOError as e:
        # reference exitFlag -3: zero read with neither EOF nor error
        # (src/main.c:84-85)
        print(f"input starved: {e}", file=sys.stderr)
        return -3
    except OSError as e:
        # reference exitFlag -2: ferror on the input stream
        # (src/main.c:78-83); the native reader surfaces the same code
        print(f"stream error: {e}", file=sys.stderr)
        return -2
    finally:
        if trace_ctx:
            import jax
            jax.profiler.stop_trace()
        if fin is not None and fin is not sys.stdin.buffer:
            fin.close()
        if fout is not None and fout is not sys.stdout.buffer:
            fout.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
