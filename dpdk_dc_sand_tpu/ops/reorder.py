"""Pre-beamform corner-turn reorder.

Replaces the reference's hand-indexed mako/CUDA kernel
(``beamformer/beamforming/kernels/prebeamform_reorder_kernel.mako:53-80``).
The corner turn is a reshape+transpose that XLA lowers to a tiled
copy — and when composed inside a jitted pipeline it is
usually folded into the consumer's operand layout and never materialised
(SURVEY.md §7 translation table). Standalone form kept for reference-layout
parity and testing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_samples_per_block",))
def prebeamform_reorder(
    samples: jax.Array, n_samples_per_block: int = 16
) -> jax.Array:
    """``[b][ant][chan][time][pol][x]`` → ``[b][pol][chan][blk][tb][ant][x]``.

    Same contract as PreBeamformReorder (prebeamform_reorder.py:133-151),
    any dtype.
    """
    b, a, c, t, p, x = samples.shape
    if t % n_samples_per_block:
        raise ValueError(
            f"time axis {t} not divisible by block size {n_samples_per_block}"
        )
    v = samples.reshape(b, a, c, t // n_samples_per_block, n_samples_per_block, p, x)
    return v.transpose(0, 5, 2, 3, 4, 1, 6)


@jax.jit
def prebeamform_reorder_inverse(reordered: jax.Array) -> jax.Array:
    """Invert :func:`prebeamform_reorder` back to ingest layout."""
    b, p, c, blocks, tb, a, x = reordered.shape
    v = reordered.transpose(0, 5, 2, 3, 4, 1, 6)
    return v.reshape(b, a, c, blocks * tb, p, x)
