"""Op and engine parity on the GPU against the host golden models.

Small shapes: these run after ``chip_smoke.py``'s flagship phases in the
same process, and as ``JAX_PLATFORMS=cuda python -m pytest tests/gpu -m
gpu`` on their own. Comparisons reduce on the device where the arrays are
large and pull small results.
"""

import numpy as np
import pytest

from dpdk_dc_sand_tpu import golden, ops
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.chain import check_codes, f_planes

pytestmark = pytest.mark.gpu

RNG = np.random.default_rng(seed=2021)
CFG = ArrayConfig(n_ants=8, n_channels=256, n_beams=4)


def max_err(device_arr, host_ref):
    """|device − host| max computed on the device, one scalar pulled."""
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(device_arr - jnp.asarray(host_ref))))


def _delays(cfg, rng):
    dv = np.zeros(cfg.delay_vals_shape, np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    return dv


def test_reorder_exact_on_gpu(gpu):
    samples = RNG.integers(-128, 127, size=CFG.ingest_shape, dtype=np.int8)
    got = ops.prebeamform_reorder(samples)
    want = golden.reorder(samples).astype(np.float32)
    assert max_err(got.astype("float32"), want) == 0.0


def test_coeffs_on_gpu(gpu):
    dv = _delays(CFG, RNG)
    cos, sin = ops.steering_coeffs(
        dv,
        n_channels=CFG.n_channels,
        n_channels_per_stream=CFG.n_channels_per_stream,
        sample_period=CFG.sample_period,
    )
    w = golden.steering_coeffs_complex(dv, CFG.n_channels, CFG.sample_period)
    assert max_err(cos, w.real.astype(np.float32)) < 1e-4
    assert max_err(sin, w.imag.astype(np.float32)) < 1e-4


def test_beamform_reference_tolerance_on_gpu(gpu):
    """f32 beamform at Precision.HIGHEST: no TF32 pass, so the reference
    tolerance rtol=atol=1e-4 (beamform_op_sequence_test.py:198-200)
    holds on the card."""
    samples = RNG.integers(-128, 127, size=CFG.ingest_shape, dtype=np.int8)
    reordered = golden.reorder(samples)
    coeffs = golden.steering_coeffs_matrix(
        _delays(CFG, RNG), CFG.n_batches, CFG.n_pols, CFG.n_channels,
        CFG.sample_period,
    )
    got = ops.beamform_matrix(reordered, coeffs)
    want = golden.beamform(reordered, coeffs)
    assert max_err(got, want) <= 1e-4 * max(1.0, np.abs(want).max())


def test_pfb_fir_on_gpu(gpu):
    n_taps, fft = 8, 512
    window = np.asarray(golden.pfb_window(n_taps, fft))
    x = RNG.integers(-64, 64, size=(2, (16 + n_taps - 1) * fft), dtype=np.int8)
    got = ops.pfb_fir(x, window)
    want = golden.pfb_fir(x.astype(np.float32), window)
    assert max_err(got, want) < 1e-3


def test_fft_and_fine_delay_on_gpu(gpu):
    import jax.numpy as jnp

    n_taps, n_channels, k = 8, 128, 37
    window = np.asarray(golden.pfb_window(n_taps, 2 * n_channels))
    n = np.arange((8 + n_taps - 1) * 2 * n_channels)
    x = (80 * np.cos(2 * np.pi * k * n / (2 * n_channels))).astype(np.float32)
    got = ops.pfb_channelise(x, window)
    assert int(jnp.argmax(jnp.abs(got[4]) ** 2)) == k


def test_requantise_exact_on_gpu(gpu):
    x = RNG.normal(scale=100, size=(256, 128)).astype(np.float32)
    got = ops.requantise(x, 0.5)
    want = golden.requantise(x, 0.5).astype(np.float32)
    assert max_err(got.astype("float32"), want) == 0.0


def test_correlator_physics_on_gpu(gpu):
    import jax.numpy as jnp

    x = RNG.integers(-100, 100, size=(16, 64, 8, 2), dtype=np.int8)
    vre, vim = ops.correlate(x)
    assert float(jnp.abs(vre - jnp.swapaxes(vre, 1, 2)).max()) == 0.0
    assert float(jnp.abs(vim + jnp.swapaxes(vim, 1, 2)).max()) == 0.0


def test_int8_gram_exact_on_gpu(gpu):
    """The int8×int8→int32 visibility dot is exact on the card."""
    x = RNG.integers(-127, 128, size=(32, 64, 24, 2), dtype=np.int8)
    vre, vim = ops.correlate(x, precision="int8")
    xr = x[..., 0].astype(np.int64)
    xi = x[..., 1].astype(np.int64)
    want_re = np.einsum("cti,ctj->cij", xr, xr) + np.einsum("cti,ctj->cij", xi, xi)
    want_im = np.einsum("cti,ctj->cij", xi, xr) - np.einsum("cti,ctj->cij", xr, xi)
    np.testing.assert_array_equal(np.asarray(vre), want_re.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(vim), want_im.astype(np.float32))


def test_f_stage_within_one_code_on_gpu(gpu):
    """FBEngine's F stage vs the golden F chain: ±1 code, rarely."""
    import functools

    import jax

    from dpdk_dc_sand_tpu.models import FBEngine
    from dpdk_dc_sand_tpu.models.fbengine import _f_stage

    cfg = ArrayConfig(n_ants=4, n_channels=1024, n_beams=4, n_taps=8)
    fb = FBEngine(cfg, n_spectra=8)
    adc, cd, fd, ph, _ = fb.example_inputs()
    f = jax.jit(functools.partial(
        _f_stage, window=fb.window, cfg=cfg, n_spectra=8,
        quant_scale=fb.quant_scale,
    ))
    qr, qi = f(adc, cd, fd, ph)
    got = np.stack([np.asarray(qr), np.asarray(qi)], axis=-1)
    want = f_planes(
        adc, cd, fd, ph, n_taps=cfg.n_taps, n_channels=cfg.n_channels,
        n_spectra=8, quant_scale=fb.quant_scale,
    )
    check_codes(got, want)


def test_sharded_engine_on_one_gpu(gpu):
    """ShardedFBEngine on a 1×1 mesh compiles for the card and equals
    FBEngine (circular-halo convention)."""
    from dpdk_dc_sand_tpu.models import FBEngine
    from dpdk_dc_sand_tpu.parallel import ShardedFBEngine, make_mesh

    cfg = ArrayConfig(n_ants=4, n_channels=1024, n_beams=4, n_taps=4)
    eng = ShardedFBEngine(cfg, make_mesh(1, shape=(1, 1)), n_spectra=16)
    adc, fd, ph, dv = eng.example_inputs()
    got = np.asarray(eng(adc, fd, ph, dv))
    halo = (cfg.n_taps - 1) * cfg.fft_size
    ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    want = np.asarray(
        FBEngine(cfg, n_spectra=16)(
            ext, np.zeros(cfg.n_ants, np.int32), fd, ph, dv
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_channelisation_leakage_on_gpu(gpu, chan_common):
    """The −62 dB leakage spec, measured on the card through the engines'
    F stage (tests/qualification/chan_common.py)."""
    power = chan_common.engine_power()
    assert int(np.argmax(power)) == chan_common.K
    worst = chan_common.worst_leakage_db(power)
    spec = chan_common.LEAKAGE_SPEC_DB
    print(f"on-card worst leakage {worst:.2f} dB (spec {spec})")
    assert worst <= spec
