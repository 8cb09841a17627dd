"""Device-op vs CPU-golden parity tests.

The reference's core test pattern (SURVEY.md §4): every accelerator op is
checked against its CPU golden model on seeded random input with
dtype-aware tolerances — exact for reorder/requant
(prebeamform_reorder_test.py:122), rtol=atol=1e-4 for the float path
(beamform_op_sequence_test.py:198-200).
"""

import numpy as np
import pytest

import tests.parameters as parameters
from dpdk_dc_sand_tpu import golden, ops
from dpdk_dc_sand_tpu.config import ArrayConfig

RNG = np.random.default_rng(seed=2021)


def make_delay_vals(cfg: ArrayConfig, rng=RNG) -> np.ndarray:
    """Random but physical delay polynomials (ns-scale delays, rad phases)."""
    dv = np.zeros(cfg.delay_vals_shape, np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 1] = rng.uniform(-1e-12, 1e-12, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    dv[..., 3] = rng.uniform(-0.1, 0.1, dv.shape[:-1])
    return dv


# ----------------------------------------------------------------------
# Corner-turn reorder: exact equality (prebeamform_reorder_test.py:122)
# ----------------------------------------------------------------------
@pytest.mark.combinations(
    "n_ants, n_channels, n_batches",
    parameters.array_size,
    parameters.num_channels,
    parameters.num_batches,
)
def test_reorder_matches_golden_exactly(n_ants, n_channels, n_batches):
    cfg = ArrayConfig(n_ants=n_ants, n_channels=n_channels, n_batches=n_batches)
    samples = RNG.integers(-128, 127, size=cfg.ingest_shape, dtype=np.int8)
    got = np.asarray(ops.prebeamform_reorder(samples))
    want = golden.reorder(samples)
    np.testing.assert_array_equal(got, want)
    # Round trip
    back = np.asarray(ops.prebeamform_reorder_inverse(got))
    np.testing.assert_array_equal(back, samples)


# ----------------------------------------------------------------------
# Steering coefficients: 1e-5 vs float64 golden (device computes f32)
# ----------------------------------------------------------------------
@pytest.mark.combinations(
    "n_ants, n_channels, n_beams",
    parameters.array_size,
    parameters.num_channels,
    parameters.num_beams,
)
def test_coeffs_match_golden(n_ants, n_channels, n_beams):
    cfg = ArrayConfig(n_ants=n_ants, n_channels=n_channels, n_beams=n_beams)
    dv = make_delay_vals(cfg)
    xeng_id = 2
    cos, sin = ops.steering_coeffs(
        dv,
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels_per_stream,
        sample_period=cfg.sample_period,
        xeng_id=xeng_id,
    )
    w = golden.steering_coeffs_complex(
        dv, cfg.n_channels, cfg.sample_period, xeng_id
    )
    np.testing.assert_allclose(np.asarray(cos), w.real, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sin), w.imag, rtol=1e-4, atol=1e-5)


def test_coeff_matrix_layout_matches_golden():
    cfg = ArrayConfig(n_ants=7, n_channels=256, n_beams=5, n_batches=2)
    dv = make_delay_vals(cfg)
    got = np.asarray(
        ops.generate_coeff_matrix(
            dv,
            n_batches=cfg.n_batches,
            n_pols=cfg.n_pols,
            n_channels=cfg.n_channels,
            n_channels_per_stream=cfg.n_channels_per_stream,
            sample_period=cfg.sample_period,
            xeng_id=1,
        )
    )
    want = golden.steering_coeffs_matrix(
        dv, cfg.n_batches, cfg.n_pols, cfg.n_channels, cfg.sample_period, 1
    )
    assert got.shape == want.shape == cfg.coeff_shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_coeffs_time_extrapolation_matches_golden():
    cfg = ArrayConfig(n_ants=4, n_channels=256, n_beams=4)
    dv = make_delay_vals(cfg)
    t = 1.5
    cos, sin = ops.steering_coeffs(
        dv,
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels_per_stream,
        sample_period=cfg.sample_period,
        t_s=t,
    )
    w = golden.steering_coeffs_complex(
        dv, cfg.n_channels, cfg.sample_period, t_s=t
    )
    np.testing.assert_allclose(np.asarray(cos), w.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sin), w.imag, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# Beamform matmul: reference tolerance rtol=atol=1e-4
# ----------------------------------------------------------------------
@pytest.mark.combinations(
    "n_ants, n_channels, n_beams, n_batches",
    parameters.array_size,
    parameters.num_channels,
    parameters.num_beams,
    parameters.num_batches,
)
def test_beamform_matrix_matches_golden(n_ants, n_channels, n_beams, n_batches):
    cfg = ArrayConfig(
        n_ants=n_ants, n_channels=n_channels, n_beams=n_beams, n_batches=n_batches
    )
    samples = RNG.integers(-128, 127, size=cfg.ingest_shape, dtype=np.int8)
    reordered = golden.reorder(samples)
    dv = make_delay_vals(cfg)
    coeffs = golden.steering_coeffs_matrix(
        dv, cfg.n_batches, cfg.n_pols, cfg.n_channels, cfg.sample_period
    )
    got = np.asarray(ops.beamform_matrix(reordered, coeffs))
    want = golden.beamform(reordered, coeffs)
    assert got.shape == cfg.beam_shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_beamform_bf16_mode_close():
    cfg = ArrayConfig(n_ants=8, n_channels=256)
    samples = RNG.integers(-128, 127, size=cfg.ingest_shape, dtype=np.int8)
    reordered = golden.reorder(samples)
    dv = make_delay_vals(cfg)
    coeffs = golden.steering_coeffs_matrix(
        dv, cfg.n_batches, cfg.n_pols, cfg.n_channels, cfg.sample_period
    )
    got = np.asarray(ops.beamform_matrix(reordered, coeffs, precision="bf16"))
    want = golden.beamform(reordered, coeffs)
    # bf16 coefficient rounding: ~1% relative (the reference's 16-bit
    # path uses 1e-1 tolerance, runBeamformerTests.cpp:61).
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1)
    assert err < 2e-2, err


def test_beamform_planar_matches_complex_golden():
    cfg = ArrayConfig(n_ants=5, n_channels=256, n_beams=3)
    cps = cfg.n_channels_per_stream
    t = 64
    samples = RNG.integers(-100, 100, size=(cps, t, 5, 2), dtype=np.int8)
    dv = make_delay_vals(cfg)
    w = golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)
    cos, sin = w.real.copy(), w.imag.copy()
    re, im = ops.beamform(samples, cos, sin)
    x = samples[..., 0] + 1j * samples[..., 1].astype(np.float64)
    want = golden.beamform_complex(x, w)
    np.testing.assert_allclose(np.asarray(re), want.real, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(im), want.imag, rtol=1e-4, atol=1e-2)


def test_beamform_planar_with_lead_dims():
    """Leading (batch, pol) axes survive the chan-batched dot_general."""
    cfg = ArrayConfig(n_ants=4, n_channels=256, n_beams=4)
    cps = cfg.n_channels_per_stream
    samples = RNG.integers(-100, 100, size=(2, 2, cps, 32, 4, 2), dtype=np.int8)
    dv = make_delay_vals(cfg)
    w = golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)
    re, im = ops.beamform(samples, w.real.copy(), w.imag.copy())
    assert re.shape == (2, 2, cps, 32, 4)
    x = samples[..., 0] + 1j * samples[..., 1].astype(np.float64)
    want = golden.beamform_complex(x, w)
    np.testing.assert_allclose(np.asarray(re), want.real, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(im), want.imag, rtol=1e-4, atol=1e-2)


def test_beamform_planes_matches_stacked():
    """Separate (re, im) plane inputs give bit-identical beams to the
    trailing-2 stacked form (same dots, different operand layout)."""
    cfg = ArrayConfig(n_ants=5, n_channels=256, n_beams=3)
    cps = cfg.n_channels_per_stream
    samples = RNG.integers(-100, 100, size=(2, cps, 48, 5, 2), dtype=np.int8)
    dv = make_delay_vals(cfg)
    w = golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)
    cos, sin = w.real.copy(), w.imag.copy()
    re0, im0 = ops.beamform(samples, cos, sin)
    re1, im1 = ops.beamform_planes(
        samples[..., 0].copy(), samples[..., 1].copy(), cos, sin
    )
    np.testing.assert_array_equal(np.asarray(re0), np.asarray(re1))
    np.testing.assert_array_equal(np.asarray(im0), np.asarray(im1))


# ----------------------------------------------------------------------
# PFB
# ----------------------------------------------------------------------
@pytest.mark.combinations(
    "n_taps, n_channels", [4, 8, 16], [128, 256, 512]
)
def test_pfb_fir_matches_golden(n_taps, n_channels):
    fft = 2 * n_channels
    window = golden.pfb_window(n_taps, fft)
    x = RNG.normal(scale=30, size=(3, (6 + n_taps - 1) * fft)).astype(np.float32)
    got = np.asarray(ops.pfb_fir(x, window))
    want = golden.pfb_fir(x, window)
    assert got.shape == want.shape == (3, 6, fft)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pfb_channelise_matches_golden_and_spec():
    n_taps, n_channels = 16, 128
    fft = 2 * n_channels
    window = golden.pfb_window(n_taps, fft)
    k = 40
    n = np.arange((8 + n_taps - 1) * fft)
    x = (100 * np.cos(2 * np.pi * k * n / fft)).astype(np.float32)
    got = np.asarray(ops.pfb_channelise(x, window))
    want = golden.pfb_channelise(x, window)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    # channelisation acceptance spec on the device op itself
    power = np.abs(got[4]) ** 2
    assert int(np.argmax(power)) == k
    rel_db = 10 * np.log10(power / power[k] + 1e-300)
    mask = np.ones(n_channels, bool)
    mask[k] = False
    assert rel_db[mask].max() <= -62.0


# ----------------------------------------------------------------------
# Delay ops
# ----------------------------------------------------------------------
def test_coarse_delay_matches_golden():
    n_ants, n = 4, 256
    stream = RNG.normal(size=(n_ants, 2, n)).astype(np.float32)
    delays = np.array([0, 3, 17, 40], np.int32)
    out_len = n - 64
    got = np.asarray(ops.coarse_delay(stream, delays, out_len))
    for a in range(n_ants):
        want = golden.coarse_delay(stream[a], int(delays[a]))[..., :out_len]
        np.testing.assert_array_equal(got[a], want)


def test_fine_delay_matches_golden():
    n_ants, n_spectra, n_channels = 3, 4, 64
    s = (
        RNG.normal(size=(n_ants, n_spectra, n_channels))
        + 1j * RNG.normal(size=(n_ants, n_spectra, n_channels))
    ).astype(np.complex64)
    d = RNG.uniform(-0.5, 0.5, n_ants).astype(np.float32)
    p = RNG.uniform(-np.pi, np.pi, n_ants).astype(np.float32)
    re, im = ops.apply_fine_delay(
        s.real.copy(), s.imag.copy(), d, p, n_channels=n_channels
    )
    want = golden.apply_fine_delay(s, d, p, n_channels)
    np.testing.assert_allclose(np.asarray(re), want.real, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(im), want.imag, rtol=1e-4, atol=1e-5)


def test_fine_delay_channel_offset():
    """Engine-local channel indexing (xeng_id offset) matches golden."""
    s = np.ones((1, 2, 8), np.complex64)
    d = np.array([0.25], np.float32)
    p = np.array([0.0], np.float32)
    re, im = ops.apply_fine_delay(
        s.real.copy(), s.imag.copy(), d, p, n_channels=64, channel_offset=16
    )
    want = golden.apply_fine_delay(s, d, p, 64, channel_offset=16)
    np.testing.assert_allclose(np.asarray(re), want.real, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(im), want.imag, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Requantisation: exact
# ----------------------------------------------------------------------
def test_requantise_matches_golden():
    x = RNG.normal(scale=100, size=(64, 64)).astype(np.float32)
    got = np.asarray(ops.requantise(x, 0.5))
    want = golden.requantise(x, 0.5)
    np.testing.assert_array_equal(got, want)
