"""Op library: conditioning, discriminator, filter extraction/apply and
polyphase resampling, in plain jax.numpy/lax."""
from .conditioning import shift_origin, normalize_input, correct_iq
from .demod import fm_demod, atan2_fast
from .fir_apply import JRealFir, JCplxFir
from .resample import PolyResampler, design_resampler_taps, kaiser_lowpass

__all__ = [
    "shift_origin", "normalize_input", "correct_iq",
    "fm_demod", "atan2_fast",
    "JRealFir", "JCplxFir",
    "PolyResampler", "design_resampler_taps", "kaiser_lowpass",
]
