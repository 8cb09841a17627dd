"""Per-antenna delay correction (F-engine stages).

Coarse delay = per-antenna integer-sample stream selection (the reference
sizes this FIFO from the delay-tracking envelope,
delay_tracking_requirements_calculator.py:145-171); fine delay = residual
sub-sample delay applied post-FFT as a per-channel phase rotation in the
same convention as the B-engine steering coefficients
(coeff_generator.py:55-65), so F and B phases compose.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("out_len",))
def coarse_delay(
    stream: jax.Array, delay_samples: jax.Array, out_len: int
) -> jax.Array:
    """Select per-antenna windows offset by integer delays.

    Parameters
    ----------
    stream:
        ``[n_ants, ..., n_samples]``; samples must carry at least
        ``max(delay) + out_len`` of history.
    delay_samples:
        ``[n_ants]`` int32 non-negative delays (traced — changing delays
        never recompiles).
    out_len:
        Static output length.

    Returns
    -------
    ``[n_ants, ..., out_len]`` with antenna ``a`` advanced by
    ``delay_samples[a]``.
    """

    def one(ant_stream, d):
        start = (0,) * (ant_stream.ndim - 1) + (d,)
        return jax.lax.dynamic_slice(
            ant_stream, start, ant_stream.shape[:-1] + (out_len,)
        )

    return jax.vmap(one)(stream, delay_samples)


@functools.partial(
    jax.jit, static_argnames=("n_channels", "channel_offset")
)
def apply_fine_delay(
    spectra_re: jax.Array,
    spectra_im: jax.Array,
    frac_delay_samples: jax.Array,
    phase_rad: jax.Array,
    *,
    n_channels: int,
    channel_offset: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Rotate channelised spectra by the fine-delay phase ramp.

    ``rot(k) = −π·d_frac·(k_abs − n_channels/2)/n_channels + phase``
    (band-centre referenced; the fringe-stopping carrier phase belongs in
    ``phase_rad``, as CAM supplies it).

    Parameters
    ----------
    spectra_re, spectra_im:
        ``[..., n_spectra, n_chan_stream]`` float32 (re, im) planes, per
        antenna in leading axes.
    frac_delay_samples, phase_rad:
        Broadcast against the leading axes (e.g. ``[n_ants]`` or
        ``[n_ants, n_pols]``).

    Returns
    -------
    Rotated ``(re, im)`` planes, float32.
    """
    n_stream = spectra_re.shape[-1]
    k = jnp.arange(n_stream, dtype=jnp.float32) + channel_offset
    d = jnp.asarray(frac_delay_samples, jnp.float32)[..., None, None]
    p = jnp.asarray(phase_rad, jnp.float32)[..., None, None]
    rot = -jnp.pi * d * (k - n_channels / 2.0) / n_channels + p
    c, s = jnp.cos(rot), jnp.sin(rot)
    re = spectra_re.astype(jnp.float32)
    im = spectra_im.astype(jnp.float32)
    return re * c - im * s, re * s + im * c
