"""Configuration for the demodulator framework.

``DemodConfig`` mirrors the reference's ``consumerArgs`` (include/matrix.h:43-57)
plus its packed mode byte (src/main.c:112, decoded at src/matrix.c:194-231),
and adds framework-level knobs (numerics profile, sharding, extensions) that
have no reference counterpart.

Mode byte layout "ww|dd|qq|ff" (default 0x10):
    bits 0-1 (f): output / input filter family — 0 Butterworth LP, 1 Cheby-I LP
    bits 2-3 (q): input conditioning — 0 shiftOrigin, 1 correctIq,
                  2 highpassDc, 3 normalizeInput
    bits 4-5 (d): demod mode — nonzero ⇒ FM demod; 0 ⇒ filter-IQ-only
    bits 6-7 (w): unused
"""
from __future__ import annotations

import dataclasses
from typing import Optional

DEFAULT_BUF_SIZE = 262144  # include/matrix.h:37-39

# Seconds of input per device block for the --wbfm and --bank families when
# --block-seconds is not given, by JAX backend.  "cpu" keeps blocks small so
# the tests run fast; "gpu" comes from a block-duration sweep on an H100
# (PERF.md, Findings).  Any other backend has no default.
BLOCK_SECONDS = {
    "cpu": {"wbfm": 0.1, "bank": 0.01},
    "gpu": {"wbfm": 1.0, "bank": 0.25},
}


def default_block_seconds(family: str) -> float:
    """Default device block duration for ``family`` ("wbfm" | "bank") on
    the current JAX backend; raises ValueError on a backend without one."""
    import jax
    plat = jax.default_backend()
    if plat not in BLOCK_SECONDS:
        raise ValueError(f"no default block duration for backend {plat!r}; "
                         "pass --block-seconds")
    return BLOCK_SECONDS[plat][family]


@dataclasses.dataclass
class DemodConfig:
    # --- reference consumerArgs fields ---
    sample_rate: float = 125000.0
    lowpass_in: float = 0.0         # -L; 0 ⇒ no input filter
    lowpass_out: float = 12500.0    # -l
    in_filter_degree: int = 0       # -D
    out_filter_degree: int = 3      # -d
    epsilon: float = 0.3            # -e arg / 10 (Chebyshev ripple exponent)
    mode: int = 0x10                # packed mode byte
    buf_size: int = DEFAULT_BUF_SIZE

    # --- framework extensions (no reference counterpart) ---
    # "compat": replicate reference numerics/quirks (zero-state blocks,
    #           partial-tail drop).  "continuous": carry filter state across
    #           blocks via overlap-save (BASELINE config 3 improvement).
    profile: str = "compat"
    # float32 mirrors the default build; float64 mirrors -DSET_PRECISION
    precision: str = "float32"
    # number of independent channels processed as a batch (BASELINE config 4)
    num_channels: int = 1

    # --- mode byte decode (src/matrix.c) ---
    def out_filter_family(self) -> int:
        return self.mode & 1        # src/matrix.c:224

    def in_filter_family(self) -> int:
        return (self.mode >> 1) & 1  # src/matrix.c:229

    def conditioning_kind(self) -> int:
        return (self.mode >> 2) & 3  # src/matrix.c:208-222

    def demod_mode(self) -> int:
        return (self.mode >> 4) & 3  # src/matrix.c:194

    def effective_in_filter_degree(self) -> int:
        """Consumer-side degree defaulting (src/matrix.c:190-192)."""
        if self.lowpass_in and not self.in_filter_degree:
            return self.out_filter_degree
        return self.in_filter_degree

    @property
    def output_len(self) -> int:
        """Demodulated REALs per block: bufSize>>2 (src/matrix.c:193)."""
        return self.buf_size >> 2

    def np_dtype(self):
        import numpy as np
        return np.float64 if self.precision == "float64" else np.float32

    def validate(self) -> "DemodConfig":
        if self.buf_size < 4 or self.buf_size % 4:
            raise ValueError(f"buf_size must be a positive multiple of 4, got {self.buf_size}")
        if self.out_filter_degree < 1:
            raise ValueError("out_filter_degree must be >= 1")
        if self.profile not in ("compat", "continuous"):
            raise ValueError(f"unknown profile {self.profile!r}")
        if self.precision not in ("float32", "float64"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.demod_mode() == 0 and not self.lowpass_in:
            raise ValueError("demod mode 0 (filter-IQ-only) requires lowpass_in; "
                             "the reference reads uninitialized coefficients here")
        return self


def config_from_cli_opts(opts: dict) -> DemodConfig:
    """Build a config from reference-style CLI options (already split).

    Replicates the getopt semantics of src/main.c:125-183: -e is divided by
    10; -m ORs into bits 0-1, -q shifts into bits 2-3, -c into bits 4-5;
    -b shifts DEFAULT_BUF_SIZE left (>=1) or right (<1); -r/-n are accepted
    but ignored.
    """
    cfg = DemodConfig()
    mode = cfg.mode
    buf_size = DEFAULT_BUF_SIZE
    for opt, arg in opts.items():
        if opt == "L":
            cfg.lowpass_in = float(arg)
        elif opt == "l":
            cfg.lowpass_out = float(arg)
        elif opt == "S":
            cfg.sample_rate = float(arg)
        elif opt == "D":
            cfg.in_filter_degree = int(arg)
        elif opt == "d":
            cfg.out_filter_degree = int(arg)
        elif opt == "e":
            cfg.epsilon = float(arg) / 10.0
        elif opt == "m":
            mode |= int(arg)
        elif opt == "c":
            mode |= int(arg) << 4
        elif opt == "q":
            mode |= int(arg) << 2
        elif opt == "b":
            shift = int(arg)
            if abs(shift) < 17:
                buf_size = (DEFAULT_BUF_SIZE << shift) if shift >= 1 \
                    else (DEFAULT_BUF_SIZE >> -shift)
    cfg.mode = mode
    cfg.buf_size = buf_size
    return cfg
