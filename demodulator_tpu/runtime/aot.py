"""Serialized-executable warm-start cache, and the one cache root.

The persistent XLA compile cache removes COMPILATION from warm CLI starts
but still pays trace + lowering + compile-cache lookup in every process.
The reference binary starts in milliseconds (src/main.c:100-198), so warm
first-output latency is a parity gap.  This module pickles the COMPILED
executable (jax.experimental.serialize_executable) keyed by everything
that shapes the computation; a hit deserializes and skips tracing,
lowering, and the compile cache entirely.

Both caches live under :func:`cache_root`: ``$JAX_COMPILATION_CACHE_DIR``
when it is set, else ``<checkout>/.jax_cache`` (gitignored).  The AOT
pickles go in its ``aot/`` subdirectory.

Safety: the key includes the jax version, backend platform + device kind,
the caller's config fingerprint, and the example input shapes/dtypes; any
failure to load falls back to the normal jit path (returning None) and the
entry is rewritten on the next successful compile.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle

__all__ = ["cache_root", "aot_cache_dir", "cached_compile",
           "cached_pipeline_jit"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_root() -> str:
    """Root of the compile cache and the AOT pickles: the directory
    JAX_COMPILATION_CACHE_DIR names, else the fixed ``.jax_cache``
    directory of the checkout (never a temporary or per-process name: the
    path is part of what makes a later process find the entries)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def aot_cache_dir() -> str | None:
    """AOT pickle directory under cache_root();
    DEMODULATOR_TPU_AOT_CACHE=0 disables the AOT cache."""
    if os.environ.get("DEMODULATOR_TPU_AOT_CACHE") == "0":
        return None
    return os.path.join(cache_root(), "aot")


def _key(parts: dict) -> str:
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


_SRC_STAMP = None


def _src_stamp() -> str:
    """Digest of the package's source files (path, mtime, size): a code
    change invalidates every cached executable, so a stale pickle can
    never shadow an edited kernel/pipeline.  ~30 stat calls, once per
    process."""
    global _SRC_STAMP
    if _SRC_STAMP is None:
        h = hashlib.sha256()
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for root, _dirs, files in sorted(os.walk(pkg)):
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                    h.update(f"{os.path.relpath(p, pkg)}:{st.st_mtime_ns}:"
                             f"{st.st_size};".encode())
                except OSError:
                    pass
        _SRC_STAMP = h.hexdigest()[:16]
    return _SRC_STAMP


def cached_compile(fn, example_args, key_parts, donate_argnums=(),
                   directory=None):
    """AOT ``jit(fn).lower(*example_args).compile()`` with a
    serialized-executable disk cache.

    ``example_args``: a tuple of pytrees of arrays or ShapeDtypeStructs
    fixing the input shapes — the returned Compiled accepts ONLY these
    shapes (callers keep a plain jit fallback for e.g. stream tails).
    Returns (executable | None, loaded: bool) — loaded is True when the
    executable came from the pickle (a cache hit), False when it was
    freshly compiled or unavailable (caller falls back to jit)."""
    import jax
    directory = directory if directory is not None else aot_cache_dir()
    if directory is None:
        return None, False
    try:
        devs = jax.devices()
        # single-device executables only: the pickled executable bakes in
        # its device assignment, and every sharded path keeps plain jit.
        # On CPU the cache is opt-in (DEMODULATOR_TPU_AOT_CACHE=1):
        # XLA:CPU AOT results are machine-feature sensitive, and CPU
        # compiles are fast anyway.
        if len(devs) != 1:
            return None, False
        dev = devs[0]
        if (dev.platform == "cpu"
                and os.environ.get("DEMODULATOR_TPU_AOT_CACHE") != "1"):
            return None, False
        shapes = jax.tree.map(
            lambda x: (tuple(x.shape), str(x.dtype)), example_args)
        # every DEMODULATOR_TPU_* toggle that can reroute the traced graph
        # must key the executable — cache/telemetry switches don't affect
        # tracing and are excluded
        env = sorted((k, v) for k, v in os.environ.items()
                     if k.startswith("DEMODULATOR_TPU_")
                     and k not in ("DEMODULATOR_TPU_AOT_CACHE",
                                   "DEMODULATOR_TPU_PHASES"))
        key = _key({"key": key_parts, "shapes": shapes,
                    "jax": jax.__version__, "platform": dev.platform,
                    "device": dev.device_kind, "src": _src_stamp(),
                    "env": env, "donate": tuple(donate_argnums)})
        path = os.path.join(directory, key + ".pkl")
    except Exception:
        return None, False
    if os.path.exists(path):
        try:
            from jax.experimental import serialize_executable as se
            with open(path, "rb") as f:
                payload, in_tree, out_tree = pickle.load(f)
            return se.deserialize_and_load(payload, in_tree, out_tree), True
        except Exception:
            pass  # stale/corrupt → recompile below and overwrite
    try:
        from jax.experimental import serialize_executable as se
        comp = jax.jit(fn, donate_argnums=donate_argnums).lower(
            *example_args).compile()
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(se.serialize(comp), f)
        os.replace(tmp, path)
        return comp, False
    except Exception:
        return None, False


def cached_pipeline_jit(call, cfg_obj, example_args, variant,
                        donate_argnums=()):
    """cached_compile for a pipeline method, keyed by the pipeline config's
    fingerprint + a variant tag + the package version.  Returns
    (executable | None, loaded) like cached_compile (caller keeps a plain
    jit fallback for other shapes / any failure)."""
    from .checkpoint import config_fingerprint
    from .. import __version__
    try:
        fp = config_fingerprint(cfg_obj)
    except Exception:
        return None, False
    return cached_compile(call, example_args,
                          {"cfg": fp, "variant": variant,
                           "pkg": __version__},
                          donate_argnums=donate_argnums)
