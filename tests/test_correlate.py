"""X-engine correlator tests: op vs golden, physics, accumulation."""

import numpy as np

from dpdk_dc_sand_tpu import golden, ops
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import XEngine

RNG = np.random.default_rng(seed=2021)


def _planar(chan=4, t=32, inputs=6):
    return RNG.integers(-100, 100, size=(chan, t, inputs, 2), dtype=np.int8)


def test_correlate_matches_golden():
    x = _planar()
    vre, vim = ops.correlate(x)
    want = golden.correlate(
        x[..., 0].astype(np.float64) + 1j * x[..., 1]
    )
    np.testing.assert_allclose(np.asarray(vre), want.real, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np.asarray(vim), want.imag, rtol=1e-5, atol=1e-2)


def test_planar_golden_matches_complex_golden():
    x = _planar()
    c = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    vre, vim = golden.correlate_planar(x[..., 0], x[..., 1])
    want = golden.correlate(c)
    np.testing.assert_allclose(vre, want.real, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(vim, want.imag, rtol=1e-5, atol=1e-3)


def test_hermitian_and_autocorrelation_properties():
    x = _planar()
    vre, vim = ops.correlate(x)
    vre, vim = np.asarray(vre), np.asarray(vim)
    # V is Hermitian: V[i,j] = conj(V[j,i])
    np.testing.assert_allclose(vre, vre.transpose(0, 2, 1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(vim, -vim.transpose(0, 2, 1), rtol=1e-5, atol=1e-3)
    # autocorrelations are real and non-negative
    diag_im = np.diagonal(vim, axis1=1, axis2=2)
    diag_re = np.diagonal(vre, axis1=1, axis2=2)
    np.testing.assert_allclose(diag_im, 0, atol=1e-3)
    assert (diag_re >= 0).all()


def test_correlated_signal_shows_in_cross_terms():
    """Two inputs carrying the same tone correlate; independent noise doesn't."""
    t = 512
    n = np.arange(t)
    tone = 50 * np.exp(2j * np.pi * 0.125 * n)
    noise = RNG.normal(scale=20, size=t) + 1j * RNG.normal(scale=20, size=t)
    x = np.zeros((1, t, 3, 2), np.float32)
    x[0, :, 0, 0], x[0, :, 0, 1] = tone.real, tone.imag
    x[0, :, 1, 0], x[0, :, 1, 1] = tone.real, tone.imag
    x[0, :, 2, 0], x[0, :, 2, 1] = noise.real, noise.imag
    vre, vim = ops.correlate(x)
    v = np.asarray(vre) + 1j * np.asarray(vim)
    coherent = abs(v[0, 0, 1])
    incoherent = abs(v[0, 0, 2])
    assert coherent > 10 * incoherent


def test_accumulate_adds():
    x = _planar()
    acc = np.zeros((4, 6, 6), np.float32)
    vre1, vim1 = ops.correlate_accumulate(x, acc, acc)
    vre2, vim2 = ops.correlate_accumulate(x, np.asarray(vre1), np.asarray(vim1))
    np.testing.assert_allclose(np.asarray(vre2), 2 * np.asarray(vre1), rtol=1e-5)


def test_xengine_window_integration():
    cfg = ArrayConfig(n_ants=3, n_channels=256)
    xe = XEngine(cfg, n_accum=4)
    samples = xe.example_inputs(n_chan=4, t_block=8)
    vre, vim = xe.integrate(samples)
    assert np.asarray(vre).shape == (4, 6, 6)
    # equals the sum of per-block correlations
    want_re = np.zeros((4, 6, 6), np.float32)
    want_im = np.zeros((4, 6, 6), np.float32)
    for b in range(4):
        r, i = golden.correlate_planar(
            samples[b, ..., 0], samples[b, ..., 1]
        )
        want_re += r
        want_im += i
    np.testing.assert_allclose(np.asarray(vre), want_re, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(vim), want_im, rtol=1e-4, atol=1e-2)


def test_int8_path_exact_vs_int64_golden():
    """The int8×int8→int32 path is bit-exact against an integer
    golden model — stronger than the f32 path's tolerance gate."""
    x = _planar(chan=3, t=257, inputs=7)
    vre, vim = ops.correlate(x, precision="int8")
    xr = x[..., 0].astype(np.int64)
    xi = x[..., 1].astype(np.int64)
    want_re = np.einsum("cti,ctj->cij", xr, xr) + np.einsum(
        "cti,ctj->cij", xi, xi
    )
    want_im = np.einsum("cti,ctj->cij", xi, xr) - np.einsum(
        "cti,ctj->cij", xr, xi
    )
    np.testing.assert_array_equal(np.asarray(vre), want_re.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(vim), want_im.astype(np.float32))


def test_int8_path_matches_f32_path_on_int8_inputs():
    x = _planar()
    v8 = ops.correlate(x, precision="int8")
    v32 = ops.correlate(x, precision="f32")
    for a, b in zip(v8, v32):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_xengine_int8_window_integration():
    cfg = ArrayConfig(n_ants=3, n_channels=8)
    xe = XEngine(cfg, n_accum=4, precision="int8")
    x = xe.example_inputs(n_chan=8, t_block=16)
    vre, vim = xe.integrate(x)
    want_re, want_im = XEngine(cfg, n_accum=4, precision="f32").integrate(x)
    np.testing.assert_allclose(
        np.asarray(vre), np.asarray(want_re), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(vim), np.asarray(want_im), rtol=1e-6
    )


def test_fxb_vis_precision_int8_default():
    from dpdk_dc_sand_tpu.models import FXBEngine

    cfg = ArrayConfig(n_ants=3, n_channels=128, n_beams=2, n_taps=4)
    eng8 = FXBEngine(cfg, n_spectra=8)
    assert eng8.vis_precision == "int8"
    engf = FXBEngine(cfg, n_spectra=8, vis_precision="f32")
    adc, cd, fd, ph = eng8.example_inputs()[:4]
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
    b8, vr8, vi8 = eng8(adc, cd, fd, ph, dv)
    bf, vrf, vif = engf(adc, cd, fd, ph, dv)
    np.testing.assert_array_equal(np.asarray(b8), np.asarray(bf))
    np.testing.assert_allclose(np.asarray(vr8), np.asarray(vrf), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vi8), np.asarray(vif), rtol=1e-6)
