"""Steering-coefficient generation.

Replaces the reference's numba CUDA kernel
(``beamformer/beamforming/coeff_generator.py:12-103``) and the native
grouped-timestamps kernel (``BeamformerKernels.cu:121-189``). The
whole computation is a broadcasted cos/sin over a rotation grid — a few
elementwise ops, fused by XLA; no custom kernel is warranted (the
reference burns four CUDA kernel variants on this).

The delay polynomial is a *runtime input* so CAM updates at the
256-accumulation cadence (BeamformerParameters.h:17) never recompile.
"""

from __future__ import annotations

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np


def steering_key(delay_vals, ant_weights, t_s: float) -> tuple:
    """Content-digest cache key for steering-plane regeneration.

    The engines cache expanded rotation planes across the
    256-accumulation reuse cadence and must regenerate them whenever the
    *values* of the delay polynomials or antenna weights change
    (coefficients track CAM updates, BeamformerParameters.h:53-66).
    Keying that cache on ``id()`` is a stale-steering hazard: CPython
    freelists readily hand a new array the address of a dead one, so a
    fresh ``?beam-delays`` solution can collide with the previous epoch's
    key and be silently dropped for a whole reuse cadence. The inputs
    are tiny (``[B][A][4]`` f32 and ``[A]`` f32), so hashing their bytes
    every chunk is noise next to a pipeline step.
    """
    dv = np.ascontiguousarray(np.asarray(delay_vals))
    digest = hashlib.blake2b(dv.tobytes(), digest_size=16)
    if ant_weights is not None:
        digest.update(
            np.ascontiguousarray(np.asarray(ant_weights, np.float32)).tobytes()
        )
    return (dv.shape, ant_weights is None, digest.hexdigest(), float(t_s))


@functools.partial(
    jax.jit, static_argnames=("n_channels", "n_channels_per_stream", "xeng_id")
)
def steering_coeffs(
    delay_vals: jax.Array,
    *,
    n_channels: int,
    n_channels_per_stream: int,
    sample_period: float | jax.Array = 1.0 / 1712e6,
    xeng_id: int = 0,
    t_s: float | jax.Array = 0.0,
) -> tuple[jax.Array, jax.Array]:
    """Per-(channel, beam, ant) steering weight (cos, sin) planes.

    Rotation convention of coeff_generator.py:55-65 with the native
    kernel's time extrapolation (BeamformerKernels.cu:153-166)::

        delay(t) = delay_s + delay_rate·t
        phase(t) = phase_rad + phase_rate·t
        rot(c)   = −π·delay(t)·(c_abs − n_channels/2)/(n_channels·T_s)
                 + phase(t)

    Parameters
    ----------
    delay_vals:
        ``[chan_per_stream][beam][ant][4]`` f32 (delay_s, delay_rate,
        phase_rad, phase_rate) — the reference delay_vals layout
        (coeff_generator.py:164-169).
    t_s:
        Scalar seconds past the polynomial epoch (may be a traced array).

    Returns
    -------
    ``(cos, sin)`` each ``[chan_per_stream][beam][ant]`` float32.
    """
    dv = delay_vals.astype(jnp.float32)
    t = jnp.asarray(t_s, jnp.float32)
    delay = dv[..., 0] + dv[..., 1] * t
    phase = dv[..., 2] + dv[..., 3] * t
    chan = (
        jnp.arange(n_channels_per_stream, dtype=jnp.float32)
        + n_channels_per_stream * xeng_id
    ).reshape(n_channels_per_stream, 1, 1)
    slope = -jnp.pi * delay / (n_channels * sample_period)
    rot = slope * (chan - n_channels / 2.0) + phase
    return jnp.cos(rot), jnp.sin(rot)


def steering_coeff_matrix(cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Expand (cos, sin) planes to 2×2 real rotation blocks.

    ``[...][beam][ant]`` → ``[...][2·ant][2·beam]`` f32 with block
    ``[[c, s], [−s, c]]`` at ``(2a, 2b)`` — the layout written by
    coeff_generator.py:91-103 that turns complex beamforming into one real
    matmul.
    """
    *lead, n_beams, n_ants = cos.shape
    # [..., beam, ant, row(i), col(j)] with block rows stacked at -2.
    m = jnp.stack(
        [jnp.stack([cos, sin], -1), jnp.stack([-sin, cos], -1)], -2
    )
    # [..., beam, ant, i, j] -> [..., ant, i, beam, j] -> [..., 2A, 2B]
    m = jnp.moveaxis(m, (-4, -3), (-2, -4))
    return m.reshape(*lead, 2 * n_ants, 2 * n_beams)


def steering_coeff_blockcat(cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Expand (cos, sin) planes to block-concat complex-fold weights.

    ``[..., beam, ant]`` → ``[..., 2A, 2B]`` with quadrant layout
    ``[[cᵀ, sᵀ], [−sᵀ, cᵀ]]`` — the fold matching samples concatenated
    as ``[re_0..re_{A−1}, im_0..im_{A−1}]`` on the contraction axis, so
    ``X @ W = [beam_re | beam_im]``. Same arithmetic as
    :func:`steering_coeff_matrix` (coeff_generator.py:91-103) in the
    lane-concat layout the folded B-stage consumes
    (:func:`~dpdk_dc_sand_tpu.ops.beamform.beamform_planes_folded`).
    """
    ct = jnp.swapaxes(cos, -1, -2)  # [..., ant, beam]
    st = jnp.swapaxes(sin, -1, -2)
    top = jnp.concatenate([ct, st], -1)  # [..., A, 2B]
    bot = jnp.concatenate([-st, ct], -1)
    return jnp.concatenate([top, bot], -2)  # [..., 2A, 2B]


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_batches",
        "n_pols",
        "n_channels",
        "n_channels_per_stream",
        "xeng_id",
    ),
)
def generate_coeff_matrix(
    delay_vals: jax.Array,
    *,
    n_batches: int,
    n_pols: int,
    n_channels: int,
    n_channels_per_stream: int,
    sample_period: float = 1.0 / 1712e6,
    xeng_id: int = 0,
    t_s: float | jax.Array = 0.0,
) -> jax.Array:
    """Full reference-layout ``outCoeffs`` matrix.

    ``[batch][pol][chan][2·ant][2·beam]`` f32, identical across batch/pol
    exactly as the reference (neither index enters the math,
    coeff_generator.py:55-65).
    """
    cos, sin = steering_coeffs(
        delay_vals,
        n_channels=n_channels,
        n_channels_per_stream=n_channels_per_stream,
        sample_period=sample_period,
        xeng_id=xeng_id,
        t_s=t_s,
    )
    m = steering_coeff_matrix(cos, sin)
    return jnp.broadcast_to(m, (n_batches, n_pols) + m.shape)
