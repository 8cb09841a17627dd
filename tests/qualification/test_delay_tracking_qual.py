"""Delay-tracking qualification (features/delay_tracking.feature).

Requirement-driven evidence for the delay-compensation physics: a known
geometric delay must be removed by the coarse + fractional + fringe
chain (struct delay_vals contract, BeamformerParameters.h:61-66), and
the steering solution must extrapolate in time via the delay/phase
rates (BeamformerKernels.cu:153-166). Unit-level coverage lives in
tests/test_delay_solution.py; this layer generates acceptance evidence.
"""

import numpy as np

from dpdk_dc_sand_tpu import delay_solution as ds
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FEngine

DELAY_SAMPLES = 3.25
K = 40


def _delayed_pair(fe: FEngine):
    """Antenna 0 on time; antenna 1 sees the wavefront late."""
    fft = fe.cfg.fft_size
    n = np.arange(fe.samples_in + 64)
    adc = np.zeros((2, fe.cfg.n_pols, n.size), np.float32)
    adc[0, :, :] = 80 * np.cos(2 * np.pi * K * n / fft)
    adc[1, :, :] = 80 * np.cos(2 * np.pi * K * (n - DELAY_SAMPLES) / fft)
    return adc


def test_delay_chain_realigns(report):
    report.step(
        "Given",
        f"two antennas whose second element sees the sky "
        f"{DELAY_SAMPLES} samples late",
    )
    cfg = ArrayConfig(n_ants=2, n_channels=128, n_taps=8)
    fe = FEngine(
        cfg, n_spectra=8, quant_scale=1.0,
        quantise_output=False,
    )
    adc = _delayed_pair(fe)
    rate = cfg.adc_sample_rate

    coarse, frac, _ = ds.delay_solution(
        np.array([0.0, DELAY_SAMPLES / rate]), np.zeros(2), np.zeros(2),
        np.zeros(2), t_s=0.0, adc_sample_rate=rate,
    )
    report.step(
        "When",
        "the F-engine corrects the coarse and fractional delay with "
        "fringe stopping",
        coarse_samples=[int(c) for c in coarse],
        frac_samples=[round(float(f), 3) for f in frac],
    )
    ph = (-np.pi * frac / 2).astype(np.float32)
    out = np.asarray(fe(adc, coarse, frac.astype(np.float32), ph))
    z = out[..., 0] + 1j * out[..., 1]
    a0, a1 = z[0, 0, 4, K], z[1, 0, 4, K]
    phase_err = float(np.angle(a1 / a0))
    report.step(
        "Then",
        "the two antennas' channelised voltages agree in phase at the "
        "tone channel",
        phase_error_rad=round(phase_err, 4),
    )
    assert abs(phase_err) < 0.02

    coherence = abs(a0 + a1) / (abs(a0) + abs(a1))
    report.step(
        "And", "the coherent beam sum recovers the aligned power",
        coherence=round(float(coherence), 5),
    )
    report.detail_entry("coherence", round(float(coherence), 5))
    assert coherence > 0.999


def test_uncorrected_delay_decorrelates(report):
    report.step(
        "Given",
        f"two antennas whose second element sees the sky "
        f"{DELAY_SAMPLES} samples late",
    )
    cfg = ArrayConfig(n_ants=2, n_channels=128, n_taps=8)
    fe = FEngine(
        cfg, n_spectra=8, quant_scale=1.0,
        quantise_output=False,
    )
    adc = _delayed_pair(fe)
    zeros_i = np.zeros(2, np.int32)
    zeros_f = np.zeros(2, np.float32)
    report.step("When", "the F-engine applies no delay correction")
    out = np.asarray(fe(adc, zeros_i, zeros_f, zeros_f))
    z = out[..., 0] + 1j * out[..., 1]
    a0, a1 = z[0, 0, 4, K], z[1, 0, 4, K]
    coherence = abs(a0 + a1) / (abs(a0) + abs(a1))
    # Expected phase error 2π·K·d/fft ≈ 3.19 rad → strong decorrelation.
    expected = abs(np.cos(np.pi * K * DELAY_SAMPLES / cfg.fft_size))
    report.step(
        "Then", "the beam power is measurably below the aligned power",
        coherence=round(float(coherence), 4),
        expected_from_geometry=round(float(expected), 4),
    )
    assert coherence < 0.5


def test_delay_rate_extrapolation(report):
    from dpdk_dc_sand_tpu.ops.coeff_gen import steering_coeffs

    report.step("Given", "a steering solution with a non-zero delay rate")
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2)
    rng = np.random.default_rng(5)
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 2e-9, (cfg.n_beams, cfg.n_ants))
    dv[..., 1] = rng.uniform(-1e-12, 1e-12, (cfg.n_beams, cfg.n_ants))
    dv[..., 2] = rng.uniform(-1, 1, (cfg.n_beams, cfg.n_ants))
    dv[..., 3] = rng.uniform(-0.01, 0.01, (cfg.n_beams, cfg.n_ants))

    t_s = 5.0
    report.step(
        "When", f"the solution is extrapolated {t_s} seconds past its epoch"
    )
    kw = dict(
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels,
        sample_period=cfg.sample_period,
    )
    cos_x, sin_x = steering_coeffs(dv, t_s=t_s, **kw)

    # Fresh solution computed AT that instant (rates folded into values).
    dv2 = dv.copy()
    dv2[..., 0] += dv[..., 1] * t_s
    dv2[..., 2] += dv[..., 3] * t_s
    dv2[..., 1] = 0.0
    dv2[..., 3] = 0.0
    cos_f, sin_f = steering_coeffs(dv2, t_s=0.0, **kw)

    err = max(
        float(np.abs(np.asarray(cos_x) - np.asarray(cos_f)).max()),
        float(np.abs(np.asarray(sin_x) - np.asarray(sin_f)).max()),
    )
    report.step(
        "Then",
        "the extrapolated steering planes equal a solution computed at "
        "that instant",
        max_plane_error=err,
    )
    report.detail_entry("max_plane_error", err)
    assert err < 1e-4
