"""X-engine cross-correlation as channel-batched matmuls.

The ASTRON tensor-core correlator the reference points at
(matrix_multiply.py:74-76, merge_gpu_repositories/do_merge.sh) computes
per-channel visibility matrices on matrix hardware; here this is a
channel-batched rank-T update ``V[c] = X[c]ᵀ·conj(X[c])`` — two real
``[A', T] @ [T, A']`` matmuls per complex component, which XLA hands to
the device's matrix units.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _gram(a: jax.Array, b: jax.Array, precision, acc=jnp.float32) -> jax.Array:
    # a, b: [C, T, I] -> [C, I, I] contracting T
    dims = (((1,), (1,)), ((0,), (0,)))
    return lax.dot_general(
        a, b, dimension_numbers=dims, precision=precision,
        preferred_element_type=acc,
    )


@functools.partial(jax.jit, static_argnames=("precision",))
def correlate_planes(
    xr: jax.Array, xi: jax.Array, precision: str = "f32"
) -> tuple[jax.Array, jax.Array]:
    """Visibilities from separate (re, im) plane inputs.

    ``xr, xi``: ``[chan, time, n_inputs]`` — the form the F stage's
    separate (re, im) planes feed directly.

    ``precision="int8"`` is the native visibility path for quantised
    voltages: int8×int8 products accumulate EXACTLY in int32 (an int8
    matmul on the matrix units — the ASTRON tensor-core correlator intent,
    matrix_multiply.py:74-76) and convert to f32 once at the end.
    Scaling: visibilities are in (requant-code)² units, identical to
    feeding the same int8 values through the f32 path — but bit-exact,
    where long f32 accumulations round. Exact while
    ``2·T·127² < 2³¹`` (T < 66 M samples per block; accumulate across
    blocks in f32 via :func:`correlate_accumulate`).
    """
    if precision == "int8":
        xr = xr.astype(jnp.int8)
        xi = xi.astype(jnp.int8)
        vre = _gram(xr, xr, None, jnp.int32) + _gram(xi, xi, None, jnp.int32)
        vim = _gram(xi, xr, None, jnp.int32) - _gram(xr, xi, None, jnp.int32)
        return vre.astype(jnp.float32), vim.astype(jnp.float32)
    prec = None if precision == "bf16" else lax.Precision.HIGHEST
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    xr = xr.astype(dt)
    xi = xi.astype(dt)
    vre = _gram(xr, xr, prec) + _gram(xi, xi, prec)
    vim = _gram(xi, xr, prec) - _gram(xr, xi, prec)
    return vre, vim


@functools.partial(jax.jit, static_argnames=("precision",))
def correlate(
    samples: jax.Array, precision: str = "f32"
) -> tuple[jax.Array, jax.Array]:
    """Accumulate visibilities for one time block.

    Parameters
    ----------
    samples:
        ``[chan, time, n_inputs, 2]`` (re, im) planar samples, any real
        dtype (int8 straight from the F-engine transport is ideal).

    Returns
    -------
    ``(V_re, V_im)`` each ``[chan, n_inputs, n_inputs]`` float32,
    ``V[c,i,j] = Σ_t x_i·conj(x_j)``.
    """
    return correlate_planes(samples[..., 0], samples[..., 1], precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def correlate_accumulate(
    samples: jax.Array,
    acc_re: jax.Array,
    acc_im: jax.Array,
    precision: str = "f32",
) -> tuple[jax.Array, jax.Array]:
    """Running accumulation across time blocks (the reference's
    ACCUMULATIONS_BEFORE_NEW_COEFFS-style integration window).

    Donate ``acc_re``/``acc_im`` at the call site for in-place updates.
    """
    vre, vim = correlate(samples, precision)
    return acc_re + vre, acc_im + vim
