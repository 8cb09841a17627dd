"""F-engine: coarse delay → PFB channelise → fine delay → requantise.

The reference's F-engine lived in katfgpu (merge_gpu_repositories/
do_merge.sh:4-10); dc_sand defines its contract: 8-bit complex channelised
output (prebeamform_reorder.py:153), SPEAD transmit geometry
(fgpu_send_prototype.py), delay envelope from delay_tracking, and the
channelisation acceptance spec (features/channelisation.feature:5-9).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.pfb import pfb_window
from dpdk_dc_sand_tpu.models.fbengine import _f_stage


class FEngine:
    """Per-antenna channeliser front end.

    Construct once per configuration; call with an ADC sample block and the
    current delay solution. Runs the same F stage as the F+B and F+X+B
    engines. All delay values are traced inputs (no
    recompilation as delays evolve).

    Parameters
    ----------
    cfg:
        System configuration. ``cfg.n_channels`` spectral channels are
        produced from real ``2·n_channels``-point FFT frames with a
        ``cfg.n_taps``-tap prototype.
    n_spectra:
        Output spectra (time samples per channel) per step.
    quant_scale:
        Requantisation gain applied before the int8 output stage.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        quantise_output: bool = True,
    ) -> None:
        self.cfg = cfg
        self.n_spectra = n_spectra
        self.quant_scale = quant_scale
        self.quantise_output = quantise_output
        self.window = jnp.asarray(np.asarray(pfb_window(cfg.n_taps, cfg.fft_size)))
        self._step = jax.jit(
            functools.partial(
                _fengine_step,
                window=self.window,
                cfg=cfg,
                n_spectra=n_spectra,
                quant_scale=quant_scale,
                quantise_output=quantise_output,
            )
        )

    @property
    def samples_in(self) -> int:
        """ADC samples consumed per antenna-pol per step (excl. delay margin)."""
        return (self.n_spectra + self.cfg.n_taps - 1) * self.cfg.fft_size

    def __call__(
        self,
        adc: jax.Array,
        coarse_delays: jax.Array,
        frac_delays: jax.Array,
        phases: jax.Array,
    ) -> jax.Array:
        """Run one channelisation step.

        Parameters
        ----------
        adc:
            ``[n_ants, n_pols, n_in]`` int8 ADC stream with
            ``n_in ≥ samples_in + max(coarse_delays)`` history.
        coarse_delays:
            ``[n_ants]`` int32 whole-sample delays.
        frac_delays:
            ``[n_ants]`` f32 residual delays in fractional samples.
        phases:
            ``[n_ants]`` f32 fringe-stopping phase (CAM supplies
            ``−π·d_frac/2`` plus sky phase).

        Returns
        -------
        ``[n_ants, n_pols, n_spectra, n_channels, 2]`` channelised,
        delay-corrected (re, im) samples — int8 (the transport format)
        when ``quantise_output``, float32 otherwise (for qualification
        measurements of the filter response, which int8 cannot express
        below its ~-40 dB per-bin quantisation floor).
        """
        return self._step(adc, coarse_delays, frac_delays, phases)

    def example_inputs(self, seed: int = 2021, margin: int = 64):
        rng = np.random.default_rng(seed)
        adc = rng.integers(
            -64,
            64,
            size=(self.cfg.n_ants, self.cfg.n_pols, self.samples_in + margin),
            dtype=np.int8,
        )
        cd = rng.integers(0, margin, size=self.cfg.n_ants).astype(np.int32)
        fd = rng.uniform(-0.5, 0.5, self.cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        return adc, cd, fd, ph


def _fengine_step(
    adc: jax.Array,
    coarse_delays: jax.Array,
    frac_delays: jax.Array,
    phases: jax.Array,
    *,
    window: jax.Array,
    cfg: ArrayConfig,
    n_spectra: int,
    quant_scale: float,
    quantise_output: bool = True,
) -> jax.Array:
    re, im = _f_stage(
        adc,
        coarse_delays,
        frac_delays,
        phases,
        window=window,
        cfg=cfg,
        n_spectra=n_spectra,
        quant_scale=quant_scale,
        quantise=quantise_output,
    )
    return jnp.stack([re, im], axis=-1)
