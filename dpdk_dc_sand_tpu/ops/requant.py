"""8-bit requantisation (F-engine output stage).

The inter-engine transport format is 8-bit complex samples
(prebeamform_reorder.py:153); this is the float→int8 conversion before
"transmit" (here: before handing the F-engine output to the B-engine /
host egress). Matches :func:`dpdk_dc_sand_tpu.golden.requantise`:
round-half-even, saturate to ±127.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def requantise(x: jax.Array, scale: jax.Array | float) -> jax.Array:
    """Scale, round-half-even, saturate to int8 ``[−127, 127]``."""
    v = jnp.rint(x.astype(jnp.float32) * scale)
    return jnp.clip(v, -127.0, 127.0).astype(jnp.int8)
