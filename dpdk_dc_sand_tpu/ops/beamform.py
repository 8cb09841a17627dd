"""Multi-beam coherent beamforming as channel-batched matmuls.

Replaces the reference's deliberately naive per-thread MAC nest
(``beamformer/beamforming/complex_mult_kernel.py:89-100``: A×2B MACs per
thread) and the fused warp-shuffle kernel
(``BeamformerKernels.cu:192-366``). With the antenna complexity folded
into the contraction axis
(complex_mult_kernel.py:126-134) the beamform is a channel-batched real
matmul ``[T, 2A] @ [2A, 2B]`` → ``lax.dot_general`` with
``preferred_element_type=float32``, which XLA hands to the matrix
units (cuBLAS on a GPU).

Precision modes
---------------
``"f32"`` (default): float32 operands and accumulate at
``lax.Precision.HIGHEST`` (no TF32 or bf16 passes), bit-faithful to the
CPU golden model within the reference tolerance rtol=atol=1e-4
(beamform_op_sequence_test.py:198-200).
``"bf16"``: bfloat16 operands, f32 accumulate — int8 samples are exact in
bf16 (8-bit significand), coefficient rounding ≈ 4e-3; the analog of the
reference's 16-bit coefficient path (BeamformerKernels.cu:101-117).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _dot(data: jax.Array, coeffs: jax.Array, precision=None) -> jax.Array:
    """Batched matmul ``[..., T, K] @ [..., K, N]`` with f32 accumulate."""
    nbatch = data.ndim - 2
    dims = (((data.ndim - 1,), (nbatch,)), (tuple(range(nbatch)),) * 2)
    return lax.dot_general(
        data,
        coeffs,
        dimension_numbers=dims,
        precision=precision,
        preferred_element_type=jnp.float32,
    )


@functools.partial(jax.jit, static_argnames=("precision",))
def beamform_matrix(
    reordered: jax.Array, coeffs: jax.Array, precision: str = "f32"
) -> jax.Array:
    """Beamform in the reference layouts.

    Parameters
    ----------
    reordered:
        ``[batch][pol][chan][block][t_in_block][ant][cplx]`` int8/uint8
        corner-turn output (prebeamform_reorder.py:135).
    coeffs:
        ``[batch][pol][chan][2·ant][2·beam]`` f32 rotation blocks
        (coeff_generator.py:171-177).

    Returns
    -------
    ``[batch][pol][chan][block][t_in_block][2·beam]`` f32 beams — the
    ``outData`` slot of matrix_multiply.py.
    """
    b, p, c, blocks, tb, a, x = reordered.shape
    data = reordered.reshape(b, p, c, blocks * tb, a * x)
    if precision == "bf16":
        out = _dot(data.astype(jnp.bfloat16), coeffs.astype(jnp.bfloat16))
    elif precision == "f32":
        # HIGHEST keeps true f32 MACs (the default lets XLA drop to
        # bf16-passes, outside the reference's 1e-4 tolerance).
        out = _dot(
            data.astype(jnp.float32),
            coeffs.astype(jnp.float32),
            precision=lax.Precision.HIGHEST,
        )
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return out.reshape(b, p, c, blocks, tb, coeffs.shape[-1])


@functools.partial(jax.jit, static_argnames=("precision",))
def beamform_planes(
    xr: jax.Array,
    xi: jax.Array,
    cos: jax.Array,
    sin: jax.Array,
    precision: str = "f32",
) -> tuple[jax.Array, jax.Array]:
    """Planar-input beamform: separate (re, im) sample planes.

    ``xr, xi``: ``[..., chan, time, ant]`` (int8 ideal). Identical math to
    :func:`beamform` but without the interleaved trailing-2 axis — the
    form the F stage's separate int8 (re, im) planes feed directly.
    """
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    wc = jnp.swapaxes(cos, -1, -2).astype(dt)  # [chan, ant, beam]
    ws = jnp.swapaxes(sin, -1, -2).astype(dt)

    def cdot(x, w):
        x2 = jnp.moveaxis(x.astype(dt), -3, 0)  # [chan, ..., time, ant]
        dims = (((x2.ndim - 1,), (1,)), ((0,), (0,)))
        out = lax.dot_general(
            x2,
            w,
            dimension_numbers=dims,
            precision=None if precision == "bf16" else lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return jnp.moveaxis(out, 0, -3)

    rr = cdot(xr, wc)
    ii = cdot(xi, ws)
    ri = cdot(xr, ws)
    ir = cdot(xi, wc)
    return rr - ii, ri + ir


@functools.partial(jax.jit, static_argnames=("precision",))
def beamform(
    samples: jax.Array,
    cos: jax.Array,
    sin: jax.Array,
    precision: str = "f32",
) -> tuple[jax.Array, jax.Array]:
    """Layout-free beamform on (re, im) planes — the fused-pipeline form.

    ``beam[..., c, t, b] = Σ_a x[..., c, t, a] · w[c, b, a]`` with
    ``w = cos + i·sin`` from :func:`~dpdk_dc_sand_tpu.ops.steering_coeffs`.

    Parameters
    ----------
    samples:
        ``(re, im)`` stacked on the last axis: ``[..., chan, time, ant, 2]``
        (any real dtype; int8 straight from the F-engine is ideal — it
        halves HBM traffic vs pre-converted f32).
    cos, sin:
        ``[chan, beam, ant]`` f32.

    Returns
    -------
    ``(beam_re, beam_im)`` each ``[..., chan, time, beam]`` float32.

    Notes
    -----
    Computed as one real matmul per complex component pair via the folded
    ``2A`` contraction — the same arithmetic as the reference's rotation
    blocks, but with the block matrix built implicitly by XLA fusion
    instead of materialised in HBM (4× less coefficient traffic).
    """
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    xr = samples[..., 0].astype(dt)
    xi = samples[..., 1].astype(dt)
    # w[c, b, a] -> contraction over a with batch dim c.
    wc = jnp.swapaxes(cos, -1, -2).astype(dt)  # [chan, ant, beam]
    ws = jnp.swapaxes(sin, -1, -2).astype(dt)

    def cdot(x, w):
        # x: [..., chan, time, ant], w: [chan, ant, beam].
        # dot_general places batch dims first, so bring chan to the front
        # for the call and restore afterwards when lead dims exist.
        x2 = jnp.moveaxis(x, -3, 0)  # [chan, ..., time, ant]
        dims = (((x2.ndim - 1,), (1,)), ((0,), (0,)))
        out = lax.dot_general(
            x2,
            w,
            dimension_numbers=dims,
            precision=None if precision == "bf16" else lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [chan, ..., time, beam]
        return jnp.moveaxis(out, 0, -3)

    # (xr + i·xi)(c + i·s) summed over ants
    rr = cdot(xr, wc)
    ii = cdot(xi, ws)
    ri = cdot(xr, ws)
    ir = cdot(xi, wc)
    return rr - ii, ri + ir


@functools.partial(jax.jit, static_argnames=("precision",))
def beamform_folded(
    samples: jax.Array, coeff_blocks: jax.Array, precision: str = "f32"
) -> jax.Array:
    """Single-pass beamform with the folded complex layout.

    The planar form (:func:`beamform`) issues four real matmuls and reads
    the sample block four times from device memory; the reference's
    rotation-block trick (complex_mult_kernel.py:30-43) folds (re, im)
    into the contraction axis and contracts once.

    Parameters
    ----------
    samples:
        ``[..., chan, time, ant, 2]`` (re, im) planar samples (int8 ideal).
    coeff_blocks:
        ``[chan, 2·ant, 2·beam]`` f32 rotation blocks from
        :func:`steering_coeff_matrix` — generate once per delay update
        (the 256-accumulation reuse cadence, BeamformerParameters.h:17),
        not per step.

    Returns
    -------
    ``[..., chan, time, beam, 2]`` float32 beams (re, im).
    """
    *lead, c, t, a, two = samples.shape
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    prec = None if precision == "bf16" else lax.Precision.HIGHEST
    x = samples.reshape(*lead, c, t, a * two).astype(dt)
    w = coeff_blocks.astype(dt)
    x2 = jnp.moveaxis(x, -3, 0)  # [chan, ..., time, 2A]
    dims = (((x2.ndim - 1,), (1,)), ((0,), (0,)))
    out = lax.dot_general(
        x2, w, dimension_numbers=dims, precision=prec,
        preferred_element_type=jnp.float32,
    )  # [chan, ..., time, 2B]
    out = jnp.moveaxis(out, 0, -3)
    return out.reshape(*lead, c, t, out.shape[-1] // 2, 2)


@functools.partial(jax.jit, static_argnames=("precision",))
def beamform_planes_folded(
    qr: jax.Array,
    qi: jax.Array,
    blocks: jax.Array,
    precision: str = "bf16",
) -> tuple[jax.Array, jax.Array]:
    """Beamform int8 F-engine planes with ONE folded dot per channel.

    The planar 4-dot form leaves the corner turn to XLA fusion, which
    lowers to many small batched matmuls (M=S, K=A, N=B) with strided
    plane reads. This form materialises the corner
    turn as one explicit int8 copy and contracts the complex fold in a
    single channel-batched matmul with M=P·S — the reference's
    rotation-block trick (complex_mult_kernel.py:126-134) in lane-concat
    layout.

    Parameters
    ----------
    qr, qi:
        ``[A, P, S, C]`` (re, im) sample planes, int8 ideal — the
        F-engine output layout, no pre-transpose needed.
    blocks:
        ``[C, 2A, 2B]`` block-concat steering weights from
        :func:`~dpdk_dc_sand_tpu.ops.steering_coeff_blockcat` (bf16
        storage recommended for the bf16 path).

    Returns
    -------
    ``(beam_re, beam_im)`` each ``[P, C, S, B]`` float32.
    """
    a, p, s, c = qr.shape
    with jax.named_scope("corner_turn"):
        xr = jnp.transpose(qr, (3, 1, 2, 0)).reshape(c, p * s, a)
        xi = jnp.transpose(qi, (3, 1, 2, 0)).reshape(c, p * s, a)
        # Materialise the corner turn as an int8 copy; the barrier stops
        # XLA re-fusing the strided reads into the dot.
        x = jax.lax.optimization_barrier(jnp.concatenate([xr, xi], -1))
    with jax.named_scope("beamform"):
        dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
        prec = None if precision == "bf16" else lax.Precision.HIGHEST
        out = lax.dot_general(
            x.astype(dt),
            blocks.astype(dt),
            (((2,), (1,)), ((0,), (0,))),
            precision=prec,
            preferred_element_type=jnp.float32,
        )  # [C, P*S, 2B]
        nb = blocks.shape[-1] // 2
        out = out.reshape(c, p, s, 2 * nb)
        beam_re = jnp.transpose(out[..., :nb], (1, 0, 2, 3))
        beam_im = jnp.transpose(out[..., nb:], (1, 0, 2, 3))
    return beam_re, beam_im
