"""B-engine: the reference's fused beamform op sequence, in JAX.

Parity target: ``beamformer/beamforming/beamform_op_sequence.py`` — the
3-op chain reorder → coeff-gen → matmul on one command queue with aliased
buffers. Here the chain is one jitted function; XLA keeps the reordered
samples and the coefficient matrix as fusion temporaries (the analog of the
compound-slot aliasing at beamform_op_sequence.py:142-156).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.ops.beamform import beamform_matrix
from dpdk_dc_sand_tpu.ops.coeff_gen import generate_coeff_matrix
from dpdk_dc_sand_tpu.ops.reorder import prebeamform_reorder


class BeamformPipeline:
    """Reference-layout B-engine for one X-engine's channel slice.

    The JAX analog of ``OpSequenceTemplate(...).instantiate(queue)``
    (beamform_op_sequence.py:69-134): construct once per configuration
    (compiles on first call, cached thereafter), then call with runtime
    data. ``delay_vals`` is a traced input — CAM delay updates at the
    256-accumulation cadence never recompile.

    Parameters
    ----------
    cfg:
        System configuration (shapes, rates).
    xeng_id:
        Which channel slice this engine owns (coeff_generator.py:49-53).
    precision:
        ``"f32"`` (reference 1e-4 accuracy) or ``"bf16"``.
    """

    def __init__(
        self, cfg: ArrayConfig, xeng_id: int = 0, precision: str = "f32"
    ) -> None:
        self.cfg = cfg
        self.xeng_id = xeng_id
        self.precision = precision
        self._step = jax.jit(
            functools.partial(
                _bengine_step,
                cfg=cfg,
                xeng_id=xeng_id,
                precision=precision,
            ),
            static_argnames=(),
        )

    def __call__(
        self, samples: jax.Array, delay_vals: jax.Array
    ) -> jax.Array:
        """Run one batch set.

        Parameters
        ----------
        samples:
            ``[batch][ant][chan][time][pol][cplx]`` int8/uint8 ingest
            layout (the ``inSamples`` slot).
        delay_vals:
            ``[chan][beam][ant][4]`` f32 delay polynomials.

        Returns
        -------
        ``[batch][pol][chan][block][t_in_block][2·beam]`` f32 beams (the
        ``outData`` slot, beam_shape).
        """
        return self._step(samples, delay_vals)

    def example_inputs(self, seed: int = 2021):
        """Seeded random inputs shaped for this configuration."""
        import numpy as np

        rng = np.random.default_rng(seed)
        samples = rng.integers(
            -128, 127, size=self.cfg.ingest_shape, dtype=np.int8
        )
        dv = np.zeros(self.cfg.delay_vals_shape, np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return samples, dv


def _bengine_step(
    samples: jax.Array,
    delay_vals: jax.Array,
    *,
    cfg: ArrayConfig,
    xeng_id: int,
    precision: str,
) -> jax.Array:
    reordered = prebeamform_reorder(samples, cfg.n_samples_per_block)
    coeffs = generate_coeff_matrix(
        delay_vals,
        n_batches=cfg.n_batches,
        n_pols=cfg.n_pols,
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels_per_stream,
        sample_period=cfg.sample_period,
        xeng_id=xeng_id,
    )
    return beamform_matrix(reordered, coeffs, precision)
