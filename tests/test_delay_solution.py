"""Delay-solution and stream-realignment tests.

The decisive check is physical: a stream whose wavefront arrives late by
an arbitrary (coarse + fractional) amount, corrected with the split
solution through the real F-engine, must re-cohere exactly with the
on-time reference antenna.
"""

import numpy as np
import pytest

from dpdk_dc_sand_tpu import delay_solution as ds
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FEngine


def test_split_delay_exact_and_convention():
    rate = 1712e6
    delays = np.array([0.0, 1.23456789e-6, 3.1e-9, 170.2 / rate])
    coarse, frac = ds.split_delay(delays, rate)
    # coarse − frac == total samples (see convention in the docstring)
    np.testing.assert_allclose(
        coarse - frac, delays * rate, rtol=0, atol=1e-5
    )
    assert coarse.dtype == np.int32 and frac.dtype == np.float32
    assert (frac >= 0).all() and (frac < 1).all()
    assert (coarse >= 0).all()


def test_polynomial_evaluation_continuity():
    c0, f0, p0 = ds.delay_solution(
        np.array([1e-6]), np.array([1e-9]), np.array([0.1]), np.array([0.05]),
        t_s=0.0, adc_sample_rate=1712e6,
    )
    c1, f1, p1 = ds.delay_solution(
        np.array([1e-6]), np.array([1e-9]), np.array([0.1]), np.array([0.05]),
        t_s=2.0, adc_sample_rate=1712e6,
    )
    total0 = c0[0] - f0[0]
    total1 = c1[0] - f1[0]
    assert total1 - total0 == pytest.approx(2e-9 * 1712e6, rel=1e-5)
    assert p1[0] == pytest.approx(0.2, rel=1e-6)


def test_chunk_alignment():
    assert ds.chunk_of_timestamp(0, 4096) == (0, 0)
    assert ds.chunk_of_timestamp(10000, 4096) == (2, 1808)
    assert ds.next_aligned_timestamp(10000, 4096) == 3 * 4096
    assert ds.next_aligned_timestamp(8192, 4096) == 8192
    with pytest.raises(ValueError):
        ds.chunk_of_timestamp(5, 4096, epoch=4096)


def test_fringe_phase():
    ph = ds.fringe_phase(np.array([1e-9]), 856e6)
    assert ph[0] == pytest.approx(-2 * np.pi * 856e6 * 1e-9)


def test_full_correction_recoheres_through_fengine():
    """Wavefront late by 5.3 samples; the split solution restores exact
    coherence with the on-time antenna through the real F-engine chain."""
    cfg = ArrayConfig(n_ants=2, n_channels=128, n_taps=8)
    fe = FEngine(cfg, n_spectra=8, quant_scale=1.0,
                 quantise_output=False)
    fft = cfg.fft_size
    k = 40
    rate = cfg.adc_sample_rate
    delay_samples = 5.3
    delay_s = delay_samples / rate

    n = np.arange(fe.samples_in + 64)
    x_ref = np.cos(2 * np.pi * k * n / fft)
    # antenna 1 sees the wavefront late: its sample m holds x(m − 5.3)
    x_late = np.cos(2 * np.pi * k * (n - delay_samples) / fft)
    adc = np.zeros((2, 2, n.size), np.float32)
    adc[0, :, :] = 80 * x_ref
    adc[1, :, :] = 80 * x_late

    coarse, frac, _ = ds.delay_solution(
        np.array([0.0, delay_s]), np.zeros(2), np.zeros(2), np.zeros(2),
        t_s=0.0, adc_sample_rate=rate,
    )
    assert list(coarse) == [0, 6] and frac[1] == pytest.approx(0.7, abs=1e-6)
    # band-centre-convention fringe term for the fractional part (CAM's
    # phase polynomial carries this in production; see verify skill notes)
    ph = (-np.pi * frac / 2).astype(np.float32)
    out = np.asarray(fe(adc, coarse, frac.astype(np.float32), ph))
    z = out[..., 0] + 1j * out[..., 1]  # [ant, pol, S, C]
    a0 = z[0, 0, 4, k]
    a1 = z[1, 0, 4, k]
    coherence = abs(a0 + a1) / (abs(a0) + abs(a1))
    phase_err = np.angle(a1 / a0)
    assert abs(abs(a1) - abs(a0)) / abs(a0) < 0.01
    assert abs(phase_err) < 0.02, phase_err
    assert coherence > 0.999
