"""Fused F+B pipeline — the flagship single-device model.

ADC streams → coarse delay → PFB channelise → fine delay → requantise →
multi-beam beamform, all inside one ``jax.jit``. This is the full signal
chain the reference prototypes sketch (SURVEY.md §1 data flow):
the F-engine stage replaces katfgpu, the B-stage replaces the
``beamform_op_sequence`` chain, and the corner turn between them is a
layout change XLA folds into the beamform matmul's operands
(prebeamform_reorder_kernel.mako's job).

Every stage runs under a stable ``jax.named_scope`` (:data:`STAGES`), so
a profiler trace attributes device time per stage
(:func:`dpdk_dc_sand_tpu.utils.profiling.stage_device_times`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.pfb import pfb_window
from dpdk_dc_sand_tpu.ops.beamform import beamform_planes, beamform_planes_folded
from dpdk_dc_sand_tpu.ops.coeff_gen import (
    steering_coeff_blockcat,
    steering_coeffs,
    steering_key,
)
from dpdk_dc_sand_tpu.ops.delay import apply_fine_delay, coarse_delay
from dpdk_dc_sand_tpu.ops.pfb import pfb_channelise
from dpdk_dc_sand_tpu.ops.requant import requantise

#: Named scopes of the F+B step, in signal-chain order ("fir" and "fft"
#: are opened inside :func:`~dpdk_dc_sand_tpu.ops.pfb.pfb_channelise`).
STAGES = (
    "coarse_delay",
    "fir",
    "fft",
    "fine_delay_requant",
    "corner_turn",
    "beamform",
)

BSTAGES = ("planar", "folded")


class FBEngine:
    """End-to-end F+B signal chain over the full band on one device.

    Parameters
    ----------
    cfg:
        System configuration; the engine channelises and beamforms all
        ``cfg.n_channels`` channels.
    n_spectra:
        Spectra produced per step (time samples per channel).
    quant_scale:
        F-engine output requantisation gain.
    precision:
        Beamform precision, ``"f32"`` or ``"bf16"``.
    bstage:
        B-stage form: ``"planar"`` (four channel-batched dots on the
        (re, im) planes, corner turn folded into the operands) or
        ``"folded"`` (one explicit int8 corner-turn copy + one
        block-complex dot per channel).
    beam_quant_scale:
        When set, beams are requantised to int8 with this gain — the
        8-bit beam transport format of the production egress (the
        reference's B-engine feeds 1 KiB 8-bit SPEAD heaps,
        test_parameters.py:22-25); ``None`` keeps f32 beams
        (matrix_multiply.py:34-35 contract).
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        beam_quant_scale: float | None = None,
        bstage: str = "planar",
    ) -> None:
        if bstage not in BSTAGES:
            raise ValueError(f"unknown bstage {bstage!r}")
        self.bstage = bstage
        self.cfg = cfg
        self.n_spectra = n_spectra
        self.quant_scale = quant_scale
        self.window = jnp.asarray(np.asarray(pfb_window(cfg.n_taps, cfg.fft_size)))
        # bf16 mode stores the steering planes in bf16 at update time, so
        # the dots read half the coefficient bytes per step. "folded"
        # pre-expands them to [C, 2A, 2B] block-concat weights for the
        # single-dot beamform.
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
                _fb_step,
                window=self.window,
                cfg=cfg,
                n_spectra=n_spectra,
                quant_scale=quant_scale,
                precision=precision,
                beam_quant_scale=beam_quant_scale,
                bstage=bstage,
            )
        )

    @property
    def samples_in(self) -> int:
        return (self.n_spectra + self.cfg.n_taps - 1) * self.cfg.fft_size

    def __call__(
        self,
        adc: jax.Array,
        coarse_delays: jax.Array,
        frac_delays: jax.Array,
        phases: jax.Array,
        delay_vals: jax.Array,
    ) -> jax.Array:
        """One pipeline step.

        Parameters
        ----------
        adc:
            ``[n_ants, n_pols, n_in]`` int8 with delay margin.
        coarse_delays / frac_delays / phases:
            ``[n_ants]`` per-antenna delay solution (F-engine side).
        delay_vals:
            ``[n_beams][n_ants][4]`` f32 steering polynomials (B-side), the
            ``struct delay_vals`` contract (BeamformerParameters.h:61-66).
            Expanded to rotation blocks once and reused across steps (the
            256-accumulation coefficient-reuse cadence) — call
            :meth:`set_beam_delays` explicitly in streaming loops.

        Returns
        -------
        ``[n_pols, n_channels, n_spectra, n_beams, 2]`` f32 beams.
        """
        self.set_beam_delays(delay_vals)
        return self.step(adc, coarse_delays, frac_delays, phases)

    def set_beam_delays(self, delay_vals, ant_weights=None, t_s: float = 0.0) -> None:
        """(Re)generate steering rotation blocks from delay polynomials.

        Cheap relative to a step but hoisted out of the hot loop:
        (cos, sin) planes are ``[n_channels, B, A]`` in device memory,
        regenerated only when the polynomial *values* change
        (content-digest cache, :func:`steering_key`) — the
        256-accumulation reuse cadence.

        ``ant_weights``: optional ``[n_ants]`` per-antenna magnitude
        weights folded into the steering planes (the servlet's
        ``?beam-weights`` contract, corr3_servlet.py:140-153).

        ``t_s``: seconds past the polynomial epoch; the delay/phase
        *rates* extrapolate the solution to this instant
        (BeamformerKernels.cu:153-166). Traced — advancing time never
        recompiles.
        """
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
        """Hot-loop step using the cached steering blocks."""
        if self._coeff_blocks is None:
            raise RuntimeError("call set_beam_delays() first")
        return self._step(
            adc, coarse_delays, frac_delays, phases, self._coeff_blocks
        )

    def example_inputs(
        self, seed: int = 2021, margin: int = 64,
        delay_budget: int | None = None,
    ):
        """Random inputs sized for one step.

        ``margin`` is the trailing headroom carried beyond ``samples_in``;
        ``delay_budget`` bounds the drawn coarse delays (default: the
        whole margin).
        """
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


def _coeff_blocks(
    delay_vals: jax.Array,
    ant_weights: jax.Array,
    t_s: jax.Array | float = 0.0,
    *,
    cfg: ArrayConfig,
    dtype=jnp.float32,
    folded: bool = False,
):
    """delay polynomials [B, A, 4] -> steering weights.

    ``folded=False``: (cos, sin) ``[C, B, A]`` planes for the 4-dot
    planar beamform. ``folded=True``: block-concat ``[C, 2A, 2B]``
    weights for the single-dot form (regenerated only on delay updates,
    so the 4× expansion costs update-time memory traffic, not step time).

    ``t_s`` (traced scalar — no recompile as time advances): seconds past
    the polynomial epoch; delay/phase rates extrapolate the solution, the
    native grouped-timestamps kernel's convention
    (BeamformerKernels.cu:153-166).
    """
    dv = jnp.broadcast_to(
        delay_vals, (cfg.n_channels,) + tuple(delay_vals.shape)
    )
    cos, sin = steering_coeffs(
        dv,
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels,
        sample_period=cfg.sample_period,
        xeng_id=0,
        t_s=t_s,
    )
    cos = cos * ant_weights
    sin = sin * ant_weights
    if folded:
        return steering_coeff_blockcat(cos, sin).astype(dtype)
    return cos.astype(dtype), sin.astype(dtype)


def _f_stage(
    adc: jax.Array,
    coarse_delays: jax.Array,
    frac_delays: jax.Array,
    phases: jax.Array,
    *,
    window: jax.Array,
    cfg: ArrayConfig,
    n_spectra: int,
    quant_scale: float,
    quantise: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Shared F stage: coarse delay + PFB + fine delay + requantise.

    Returns ``(qr, qi)`` int8 ``[A, P, S, C]`` planes — consumed by the
    B stage and (in the FXB engine) the correlator. ``quantise=False``
    returns the scaled f32 planes instead (filter-response measurements,
    which int8 cannot express below its per-bin quantisation floor).
    """
    out_len = (n_spectra + cfg.n_taps - 1) * cfg.fft_size
    with jax.named_scope("coarse_delay"):
        aligned = coarse_delay(adc, coarse_delays, out_len)
    spectra = pfb_channelise(
        aligned, window, n_channels=cfg.n_channels
    )  # [A, P, S, C] complex64
    with jax.named_scope("fine_delay_requant"):
        re, im = apply_fine_delay(
            jnp.real(spectra),
            jnp.imag(spectra),
            frac_delays[:, None],
            phases[:, None],
            n_channels=cfg.n_channels,
        )
        if not quantise:
            return re * quant_scale, im * quant_scale
        # (re, im) stay separate int8 planes through the F→B handoff:
        # the B and X consumers read planes, and a trailing-2 stack
        # would add a relayout between the stages.
        qr = requantise(re, quant_scale)  # [A, P, S, C] int8
        qi = requantise(im, quant_scale)
    return qr, qi


def _b_stage(
    qr: jax.Array,
    qi: jax.Array,
    coeff_blocks,
    *,
    cfg: ArrayConfig,
    precision: str,
    bstage: str = "planar",
    beam_quant_scale: float | None = None,
) -> jax.Array:
    """Shared B stage: corner turn + multi-beam matmul (+ beam requant).

    Consumes the F-stage int8 planes; returns ``[P, C, S, B, 2]`` beams
    (f32, or int8 when ``beam_quant_scale``).
    """
    if bstage == "folded":
        # One explicit int8 corner-turn copy + one folded block-complex
        # dot per channel (M = P·S); the op opens both stage scopes.
        beam_re, beam_im = beamform_planes_folded(
            qr, qi, coeff_blocks, precision
        )
    else:
        with jax.named_scope("corner_turn"):
            # [A, P, S, C] -> [P, C, S, A] per plane
            xr = jnp.transpose(qr, (1, 3, 2, 0))
            xi = jnp.transpose(qi, (1, 3, 2, 0))
        with jax.named_scope("beamform"):
            cos, sin = coeff_blocks
            beam_re, beam_im = beamform_planes(xr, xi, cos, sin, precision)
    with jax.named_scope("beamform"):
        if beam_quant_scale is not None:
            beam_re = requantise(beam_re, beam_quant_scale)
            beam_im = requantise(beam_im, beam_quant_scale)
        return jnp.stack([beam_re, beam_im], axis=-1)


def _fb_step(
    adc: jax.Array,
    coarse_delays: jax.Array,
    frac_delays: jax.Array,
    phases: jax.Array,
    coeff_blocks: jax.Array,
    *,
    window: jax.Array,
    cfg: ArrayConfig,
    n_spectra: int,
    quant_scale: float,
    precision: str,
    beam_quant_scale: float | None = None,
    bstage: str = "planar",
) -> jax.Array:
    qr, qi = _f_stage(
        adc,
        coarse_delays,
        frac_delays,
        phases,
        window=window,
        cfg=cfg,
        n_spectra=n_spectra,
        quant_scale=quant_scale,
    )
    return _b_stage(
        qr,
        qi,
        coeff_blocks,
        cfg=cfg,
        precision=precision,
        bstage=bstage,
        beam_quant_scale=beam_quant_scale,
    )
