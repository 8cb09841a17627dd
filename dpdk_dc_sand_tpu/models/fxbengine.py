"""FXB engine: one F stage feeding both the beamformer and the correlator.

The full instrument the reference sandbox was building toward
(merge_gpu_repositories/do_merge.sh: katfgpu + katxgpu → katgpucbf): the
channelised, delay-corrected, requantised antenna voltages fan out to the
B-engine (multi-beam matmul) and the X-engine (visibility integration)
inside one jit — the F-stage output is computed once and consumed twice
without leaving device memory.

The F and B stages are the same code paths as :class:`FBEngine`
(``_f_stage`` / ``_b_stage``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.pfb import pfb_window
from dpdk_dc_sand_tpu.models.fbengine import (
    BSTAGES,
    _b_stage,
    _coeff_blocks,
    _f_stage,
)
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_key
from dpdk_dc_sand_tpu.ops.correlate import correlate_planes


class FXBEngine:
    """Fused F + X + B signal chain on one device.

    Per step returns ``(beams, vis_re, vis_im)``:

    - beams ``[n_pols, n_channels, n_spectra, n_beams, 2]`` f32 (int8
      when ``beam_quant_scale`` is set);
    - visibilities ``[n_channels, n_inputs, n_inputs]`` f32 each, the
      step's spectra integrated (accumulate across steps on the caller's
      side or via :class:`~dpdk_dc_sand_tpu.models.XEngine` windows),
      with ``n_inputs = n_ants · n_pols``.

    ``bstage`` follows :class:`FBEngine`. ``vis_precision`` selects the
    visibility arithmetic: ``"int8"`` (default; exact int8×int8→int32
    gram of the requantised voltages), ``"f32"`` or ``"bf16"``.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 32,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        bstage: str = "planar",
        beam_quant_scale: float | None = None,
        vis_precision: str = "int8",
    ) -> None:
        if vis_precision not in ("int8", "f32", "bf16"):
            raise ValueError(f"unknown vis_precision {vis_precision!r}")
        if bstage not in BSTAGES:
            raise ValueError(f"unknown bstage {bstage!r}")
        self.vis_precision = vis_precision
        self.bstage = bstage
        self.cfg = cfg
        self.n_spectra = n_spectra
        self.window = jnp.asarray(np.asarray(pfb_window(cfg.n_taps, cfg.fft_size)))
        self._coeff_fn = jax.jit(
            functools.partial(
                _coeff_blocks,
                cfg=cfg,
                dtype=jnp.bfloat16 if precision == "bf16" else jnp.float32,
                folded=(bstage == "folded"),
            )
        )
        self._coeff_blocks = None
        self._coeff_key = None
        self._step = jax.jit(
            functools.partial(
                _fxb_step,
                window=self.window,
                cfg=cfg,
                n_spectra=n_spectra,
                quant_scale=quant_scale,
                precision=precision,
                bstage=bstage,
                beam_quant_scale=beam_quant_scale,
                vis_precision=vis_precision,
            )
        )

    @property
    def samples_in(self) -> int:
        return (self.n_spectra + self.cfg.n_taps - 1) * self.cfg.fft_size

    def set_beam_delays(self, delay_vals, ant_weights=None, t_s: float = 0.0) -> None:
        """Same contract as :meth:`FBEngine.set_beam_delays` (t_s
        extrapolates via the delay/phase rates, traced, no recompile)."""
        key = steering_key(delay_vals, ant_weights, t_s)
        if self._coeff_blocks is None or key != self._coeff_key:
            w = (
                jnp.ones(self.cfg.n_ants, jnp.float32)
                if ant_weights is None
                else jnp.asarray(ant_weights, jnp.float32)
            )
            self._coeff_blocks = self._coeff_fn(
                jnp.asarray(delay_vals), w, jnp.float32(t_s)
            )
            self._coeff_key = key

    def step(self, adc, coarse_delays, frac_delays, phases):
        """Hot-loop step using the cached steering planes."""
        if self._coeff_blocks is None:
            raise RuntimeError("call set_beam_delays() first")
        return self._step(adc, coarse_delays, frac_delays, phases, self._coeff_blocks)

    def __call__(self, adc, coarse_delays, frac_delays, phases, delay_vals):
        self.set_beam_delays(delay_vals)
        return self._step(adc, coarse_delays, frac_delays, phases, self._coeff_blocks)

    def example_inputs(
        self, seed: int = 2021, margin: int = 64, delay_budget: int | None = None
    ):
        """Same contract as :meth:`FBEngine.example_inputs`."""
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        adc = rng.integers(
            -64, 64, size=(cfg.n_ants, cfg.n_pols, self.samples_in + margin),
            dtype=np.int8,
        )
        if delay_budget is None:
            delay_budget = margin
        cd = rng.integers(0, delay_budget, size=cfg.n_ants).astype(np.int32)
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return adc, cd, fd, ph, dv


def _fxb_step(
    adc: jax.Array,
    coarse_delays: jax.Array,
    frac_delays: jax.Array,
    phases: jax.Array,
    coeffs,
    *,
    window: jax.Array,
    cfg: ArrayConfig,
    n_spectra: int,
    quant_scale: float,
    precision: str,
    bstage: str = "planar",
    beam_quant_scale: float | None = None,
    vis_precision: str = "int8",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    # ---- shared F stage (same code path as FBEngine) ----
    qr, qi = _f_stage(
        adc,
        coarse_delays,
        frac_delays,
        phases,
        window=window,
        cfg=cfg,
        n_spectra=n_spectra,
        quant_scale=quant_scale,
    )  # [A, P, S, C] int8 planes

    # ---- B stage (same code path as FBEngine) ----
    beams = _b_stage(
        qr,
        qi,
        coeffs,
        cfg=cfg,
        precision=precision,
        bstage=bstage,
        beam_quant_scale=beam_quant_scale,
    )

    # ---- X stage over the same quantised voltages ----
    a, p, s, c = qr.shape
    with jax.named_scope("correlate"):
        cr = jnp.transpose(qr, (3, 2, 0, 1)).reshape(c, s, a * p)
        ci = jnp.transpose(qi, (3, 2, 0, 1)).reshape(c, s, a * p)
        vis_re, vis_im = correlate_planes(cr, ci, vis_precision)
    return beams, vis_re, vis_im
