"""Beam-steering qualification (features/beam_steering.feature).

Evidence that the B-engine points: steering from delay polynomials
coherently sums a source with per-antenna arrival phases, attenuates it
off-source, and folds CAM per-antenna weights into the sum (the
?beam-weights fan-out contract, corr3_servlet.py:140-153).
"""

import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FBEngine

K = 40


def _phased_array(fb: FBEngine, phases: np.ndarray) -> np.ndarray:
    """Each antenna sees the tone with its own arrival phase."""
    cfg = fb.cfg
    n = np.arange(fb.samples_in + 8)
    adc = np.zeros((cfg.n_ants, cfg.n_pols, n.size), np.float32)
    for a, phi in enumerate(phases):
        adc[a, :, :] = 80 * np.cos(2 * np.pi * K * n / cfg.fft_size + phi)
    return np.clip(np.round(adc), -127, 127).astype(np.int8)


def _beam_power(out: np.ndarray, beam: int) -> float:
    power = out[..., 0].astype(np.float64) ** 2 + out[..., 1] ** 2
    return float(power[0, K, 4, beam])


def test_steered_beam_recovers_array_gain(report):
    report.step(
        "Given",
        "a 4-antenna array observing a tone with per-antenna phase "
        "gradients",
    )
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=8)
    fb = FBEngine(cfg, n_spectra=8, quant_scale=1.0)
    # Uniform phase gradient spanning a full turn: the un-steered
    # (boresight) sum Σ e^{i·a·2π/n} is an exact null, so off-source
    # rejection is limited only by the digitiser quantisation.
    phases = np.arange(cfg.n_ants) * (2 * np.pi / cfg.n_ants)
    adc = _phased_array(fb, phases)
    zeros_i = np.zeros(cfg.n_ants, np.int32)
    zeros_f = np.zeros(cfg.n_ants, np.float32)

    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
    dv[0, :, 2] = -phases  # beam 0: conjugate-phase steering at the source
    dv[1, :, 2] = 0.0  # beam 1: boresight (off-source for this geometry)
    report.step(
        "When", "one beam is steered at the source and one beam away from it",
        steering_phases=[round(float(p), 3) for p in phases],
    )
    out = np.asarray(fb(adc, zeros_i, zeros_f, zeros_f, dv))
    p_on, p_off = _beam_power(out, 0), _beam_power(out, 1)

    # Single-antenna reference: one antenna's channelised power.
    solo_cfg = ArrayConfig(n_ants=1, n_channels=128, n_beams=1, n_taps=8)
    solo = FBEngine(solo_cfg, n_spectra=8, quant_scale=1.0)
    adc0 = adc[:1]
    out0 = np.asarray(
        solo(
            adc0, np.zeros(1, np.int32), np.zeros(1, np.float32),
            np.zeros(1, np.float32), np.zeros((1, 1, 4), np.float32),
        )
    )
    p_single = _beam_power(out0, 0)
    gain = p_on / p_single
    report.step(
        "Then", "the on-source beam recovers the coherent array gain",
        measured_gain=round(gain, 2),
        ideal_gain=cfg.n_ants**2,
    )
    assert gain > 0.95 * cfg.n_ants**2

    # p_off can be an exact 0 (the quantised four-phase null cancels
    # perfectly); floor it so the evidence shows a finite bound.
    ratio_db = 10 * np.log10(max(p_off, 1e-12 * p_on) / p_on)
    report.step(
        "And", "the off-source beam is at least 20 dB down",
        off_source_db=round(float(ratio_db), 2),
    )
    report.detail_entry("off_source_rejection_db", round(float(ratio_db), 2))
    assert ratio_db < -20.0


def test_antenna_weights_scale_the_beam(report):
    report.step("Given", "a steered beam with one antenna weighted to zero")
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=1, n_taps=8)
    fb = FBEngine(cfg, n_spectra=8, quant_scale=1.0)
    adc = _phased_array(fb, np.zeros(cfg.n_ants))
    zeros_i = np.zeros(cfg.n_ants, np.int32)
    zeros_f = np.zeros(cfg.n_ants, np.float32)
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)

    fb.set_beam_delays(dv)
    full = _beam_power(
        np.asarray(fb.step(adc, zeros_i, zeros_f, zeros_f)), 0
    )
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    report.step("When", "the weighted beam is formed", weights=weights.tolist())
    fb.set_beam_delays(dv, ant_weights=weights)
    part = _beam_power(
        np.asarray(fb.step(adc, zeros_i, zeros_f, zeros_f)), 0
    )
    expect = ((cfg.n_ants - 1) / cfg.n_ants) ** 2
    report.step(
        "Then",
        "the beam amplitude equals the (n_ants - 1) partial sum",
        power_ratio=round(part / full, 4),
        expected=round(expect, 4),
    )
    assert abs(part / full - expect) < 0.01
