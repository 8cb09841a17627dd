"""End-to-end bf16 beam-pipeline accuracy budget.

The bf16 beamform precision mode is the analog of the reference's
16-bit coefficient output (BeamformerKernels.cu:101-117), which the
reference ships UNVERIFIED ("not checked for correctness",
BeamformerCoefficientTest.cu:281-287) and only bounds indirectly through
the fused kernel's 1e-1 tolerance (runBeamformerTests.cpp:61). Here the
budget is measured and pinned:

- int8 samples are exact in bf16 (8-bit significand covers [-128, 127]);
- steering coefficients round with relative step 2^-8 ≈ 3.9e-3;
- accumulated over 2·n_ants uncorrelated roundings, the beam-level
  relative RMS error stays at the coefficient rounding scale (~4e-3),
  two orders inside the reference's 1e-1 fused-kernel tolerance.
"""

import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FBEngine


def _beam_errors(cfg, n_spectra=8, seed=2021):
    fb32 = FBEngine(cfg, n_spectra=n_spectra, precision="f32")
    fb16 = FBEngine(cfg, n_spectra=n_spectra, precision="bf16")
    args = fb32.example_inputs(seed=seed)
    want = np.asarray(fb32(*args), np.float64)
    got = np.asarray(fb16(*args), np.float64)
    signal = np.sqrt(np.mean(want**2))
    rel_rms = np.sqrt(np.mean((got - want) ** 2)) / signal
    rel_max = np.max(np.abs(got - want)) / np.max(np.abs(want))
    return rel_rms, rel_max


def test_bf16_pipeline_error_budget():
    """bf16 beams vs the validated f32 path: relative RMS ≈ coefficient
    rounding (2^-8), bounded at 1e-2; max error inside the reference's
    1e-1 fused tolerance."""
    cfg = ArrayConfig(n_ants=16, n_channels=256, n_beams=4, n_taps=8)
    rel_rms, rel_max = _beam_errors(cfg)
    print(f"bf16 beam error: rel_rms={rel_rms:.2e} rel_max={rel_max:.2e}")
    assert rel_rms < 1e-2, rel_rms
    assert rel_max < 1e-1, rel_max
    # and it is a real low-precision path, not accidentally f32
    assert rel_rms > 1e-5


def test_bf16_error_stable_with_antenna_count():
    """Rounding errors stay uncorrelated: doubling antennas must not
    double the relative error (coherent-gain regression guard)."""
    base = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    wide = ArrayConfig(n_ants=32, n_channels=128, n_beams=4, n_taps=4)
    rms_a, _ = _beam_errors(base)
    rms_b, _ = _beam_errors(wide)
    assert rms_b < 3 * rms_a, (rms_a, rms_b)
