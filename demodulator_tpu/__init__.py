"""FM software-radio framework in JAX (capabilities of peads/demodulator).

See SURVEY.md for the reference analysis this build follows.
"""
import jax as _jax

# Dense filter-head corrections are evaluated in float64 (tiny matrices);
# everything hot stays float32/bfloat16.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
