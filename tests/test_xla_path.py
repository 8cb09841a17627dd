"""The engines' XLA path against the golden chain, across geometries.

The F stage (coarse delay → tap-sum FIR → XLA real FFT → fine delay →
requantise) is held to the golden F chain within the int8 code budget of
:func:`dpdk_dc_sand_tpu.golden.chain.check_codes`; the B and X stages are
then checked on the device's own int8 planes, so no code flip of the F
stage can hide in their tolerances.
"""

import functools

import jax
import numpy as np
import pytest

from dpdk_dc_sand_tpu import golden
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.chain import check_codes, f_planes
from dpdk_dc_sand_tpu.models import FBEngine, FEngine, FXBEngine
from dpdk_dc_sand_tpu.models.fbengine import _f_stage
from dpdk_dc_sand_tpu.parallel import ShardedFBEngine, make_mesh


def _device_planes(eng, adc, cd, fd, ph):
    f = jax.jit(functools.partial(
        _f_stage, window=eng.window, cfg=eng.cfg, n_spectra=eng.n_spectra,
        quant_scale=1.0 / 16.0,
    ))
    qr, qi = f(adc, cd, fd, ph)
    return np.stack([np.asarray(qr), np.asarray(qi)], axis=-1)


def _golden_planes(cfg, n_spectra, adc, cd, fd, ph):
    return f_planes(
        adc, cd, fd, ph, n_taps=cfg.n_taps, n_channels=cfg.n_channels,
        n_spectra=n_spectra, quant_scale=1.0 / 16.0,
    )


def _golden_beams(cfg, planes, dv):
    x = (planes[..., 0].astype(np.float64) + 1j * planes[..., 1]).transpose(
        1, 3, 2, 0
    )  # [P, C, S, A]
    w = golden.steering_coeffs_complex(
        np.broadcast_to(dv, (cfg.n_channels,) + dv.shape),
        cfg.n_channels, cfg.sample_period,
    )
    return golden.beamform_complex(x, w)  # [P, C, S, B]


@pytest.mark.parametrize("n_channels", [64, 128, 256, 512, 1024])
def test_f_stage_matches_golden_chain(n_channels):
    """XLA F stage ≡ golden F chain within ±1 code, rarely (the channel
    counts the retired fused-kernel tests covered, and smaller)."""
    cfg = ArrayConfig(n_ants=3, n_channels=n_channels, n_beams=2, n_taps=8)
    fb = FBEngine(cfg, n_spectra=8)
    adc, cd, fd, ph, _ = fb.example_inputs()
    got = _device_planes(fb, adc, cd, fd, ph)
    check_codes(got, _golden_planes(cfg, 8, adc, cd, fd, ph))


# (n_ants, n_channels, n_beams, n_taps, bstage, precision, beam_quant_scale)
GEOMETRIES = [
    (2, 64, 1, 4, "planar", "f32", None),
    (5, 64, 3, 4, "folded", "f32", None),
    (4, 128, 2, 8, "planar", "f32", None),
    (8, 128, 4, 8, "folded", "f32", None),
    (3, 256, 5, 16, "planar", "f32", None),
    (6, 256, 2, 4, "planar", "bf16", None),
    (4, 512, 4, 8, "folded", "bf16", None),
    (4, 128, 4, 4, "planar", "f32", 0.25),
    (7, 64, 3, 8, "folded", "f32", 0.5),
    (16, 64, 8, 4, "planar", "bf16", 0.125),
]


@pytest.mark.parametrize(
    "n_ants,n_channels,n_beams,n_taps,bstage,precision,bq", GEOMETRIES
)
def test_fbengine_matches_golden(
    n_ants, n_channels, n_beams, n_taps, bstage, precision, bq
):
    cfg = ArrayConfig(
        n_ants=n_ants, n_channels=n_channels, n_beams=n_beams, n_taps=n_taps
    )
    fb = FBEngine(
        cfg, n_spectra=8, precision=precision, bstage=bstage,
        beam_quant_scale=bq,
    )
    adc, cd, fd, ph, dv = fb.example_inputs()
    got = np.asarray(fb(adc, cd, fd, ph, dv))
    assert got.shape == (cfg.n_pols, n_channels, 8, n_beams, 2)
    planes = _device_planes(fb, adc, cd, fd, ph)
    check_codes(planes, _golden_planes(cfg, 8, adc, cd, fd, ph))
    want = _golden_beams(cfg, planes, dv)
    want = np.stack([want.real, want.imag], -1).astype(np.float32)
    if bq is not None:
        # int8 beams: requant of nearly equal floats, so ties may flip.
        assert got.dtype == np.int8
        check_codes(got, golden.requantise(want, bq), max_frac=1e-2)
    elif precision == "f32":
        # The reference tolerance, beamform_op_sequence_test.py:198-200.
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-4 * np.abs(want).max()
        )
    else:
        # bf16 coefficients: the tests/test_precision.py budget.
        err = got - want
        rms = np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(want ** 2))
        assert rms < 1e-2
        assert np.abs(err).max() < 1e-1 * np.sqrt(np.mean(want ** 2))


@pytest.mark.parametrize(
    "n_ants,n_channels,n_taps,n_spectra",
    [(2, 64, 4, 8), (3, 128, 8, 16), (5, 64, 4, 32), (8, 256, 8, 8),
     (4, 512, 16, 8)],
)
def test_fxb_int8_visibilities_bit_exact(n_ants, n_channels, n_taps, n_spectra):
    """FXB int8 visibilities ≡ golden correlation of the device's own
    int8 planes, bit for bit; its beams ≡ FBEngine's."""
    cfg = ArrayConfig(
        n_ants=n_ants, n_channels=n_channels, n_beams=2, n_taps=n_taps
    )
    fxb = FXBEngine(cfg, n_spectra=n_spectra)
    adc, cd, fd, ph, dv = fxb.example_inputs()
    beams, vre, vim = fxb(adc, cd, fd, ph, dv)
    planes = _device_planes(fxb, adc, cd, fd, ph)  # [A, P, S, C, 2]
    x = planes.transpose(3, 2, 0, 1, 4).reshape(
        n_channels, n_spectra, n_ants * cfg.n_pols, 2
    )
    want_re, want_im = golden.correlate_planar(x[..., 0], x[..., 1])
    np.testing.assert_array_equal(np.asarray(vre), want_re)
    np.testing.assert_array_equal(np.asarray(vim), want_im)
    fb = FBEngine(cfg, n_spectra=n_spectra)
    np.testing.assert_array_equal(
        np.asarray(beams), np.asarray(fb(adc, cd, fd, ph, dv))
    )


MESHES = [(1, 4), (2, 2), (4, 1), (2, 4), (4, 2)]


def _sharded_vs_single(shape, **kw):
    n_dev = shape[0] * shape[1]
    mesh = make_mesh(n_dev, shape=shape)
    cfg = ArrayConfig(n_ants=8, n_channels=64, n_beams=4, n_taps=4)
    n_spectra = 4 * shape[1]
    eng = ShardedFBEngine(cfg, mesh, n_spectra=n_spectra, **kw)
    adc, fd, ph, dv = eng.example_inputs()
    out = eng(adc, fd, ph, dv)
    halo = (cfg.n_taps - 1) * cfg.fft_size
    ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    zeros = np.zeros(cfg.n_ants, np.int32)
    return cfg, n_spectra, ext, zeros, fd, ph, dv, out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("scatter", [False, True], ids=["psum", "scatter"])
def test_sharded_xla_matches_single_device(shape, scatter):
    cfg, s, ext, zeros, fd, ph, dv, out = _sharded_vs_single(
        shape, scatter_beams=scatter
    )
    want = np.asarray(FBEngine(cfg, n_spectra=s)(ext, zeros, fd, ph, dv))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_xla_visibilities_match_single_device(shape):
    cfg, s, ext, zeros, fd, ph, dv, out = _sharded_vs_single(
        shape, emit_visibilities=True
    )
    beams, vre, vim = out
    fxb = FXBEngine(cfg, n_spectra=s, vis_precision="f32")
    wb, wre, wim = fxb(ext, zeros, fd, ph, dv)
    np.testing.assert_allclose(np.asarray(beams), np.asarray(wb),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(vre), np.asarray(wre), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(vim), np.asarray(wim),
                               rtol=1e-5, atol=1e-3)


def test_fengine_runs_the_engines_f_stage():
    """FEngine's output is the shared F stage's planes, stacked."""
    cfg = ArrayConfig(n_ants=3, n_channels=128, n_taps=8)
    fe = FEngine(cfg, n_spectra=8)
    adc, cd, fd, ph = fe.example_inputs()
    np.testing.assert_array_equal(
        np.asarray(fe(adc, cd, fd, ph)), _device_planes(fe, adc, cd, fd, ph)
    )


@pytest.mark.parametrize("bad", ["turned", "fused", "auto"])
def test_engines_reject_retired_bstages(bad):
    cfg = ArrayConfig(n_ants=2, n_channels=64, n_beams=1, n_taps=4)
    with pytest.raises(ValueError, match="bstage"):
        FBEngine(cfg, n_spectra=8, bstage=bad)
    with pytest.raises(ValueError, match="bstage"):
        FXBEngine(cfg, n_spectra=8, bstage=bad)
