"""Shared channelisation-qualification measurement helpers.

Used by the CPU qualification (``test_channelisation_production.py``) and
by the on-card measurement (``tests/gpu/test_engines_on_gpu.py``), so both
numbers come from the same tone, the same engine F stage and the same
leakage statistic — only the device differs.
"""

from __future__ import annotations

import numpy as np

from dpdk_dc_sand_tpu import golden

LEAKAGE_SPEC_DB = -62.0
C, TAPS, S = 512, 16, 8
FFT = 2 * C
K = 100


def make_tone() -> np.ndarray:
    """TPDF-dithered 8-bit digitiser CW tone at channel-``K`` centre.

    An undithered integer-frequency tone quantises into deterministic
    harmonics ~−58 dBc that would mask the filterbank; ±1-code
    triangular dither whitens the error to a flat ≈−71 dB/bin floor,
    below the −62 dB spec line (standard ADC test practice).
    """
    n_frames = S + TAPS - 1
    n = np.arange(n_frames * FFT)
    rng = np.random.default_rng(2021)
    dither = rng.uniform(-0.5, 0.5, n.size) + rng.uniform(-0.5, 0.5, n.size)
    tone = np.clip(
        np.round(120 * np.cos(2 * np.pi * K * n / FFT) + dither), -127, 127
    ).astype(np.int8)
    return tone.reshape(1, 1, n_frames, FFT)


def engine_power() -> np.ndarray:
    """Per-channel mean power of the engine F stage's unquantised output.

    :class:`~dpdk_dc_sand_tpu.models.FEngine` runs the F stage the F+B and
    F+X+B engines ship; ``quantise_output=False`` emits the rotated f32
    planes so the int8 transport floor cannot mask the filterbank.
    """
    from dpdk_dc_sand_tpu.config import ArrayConfig
    from dpdk_dc_sand_tpu.models import FEngine

    cfg = ArrayConfig(n_ants=1, n_channels=C, n_taps=TAPS)
    fe = FEngine(cfg, n_spectra=S, quant_scale=1.0, quantise_output=False)
    tone = make_tone().reshape(1, 1, -1)
    adc = np.broadcast_to(tone, (1, cfg.n_pols, tone.shape[-1])).copy()
    zero = np.zeros(1, np.float32)
    out = np.asarray(fe(adc, np.zeros(1, np.int32), zero, zero), np.float64)
    power = out[..., 0] ** 2 + out[..., 1] ** 2  # [A, P, S, C]
    # Average over spectra: tightens the dither-floor variance (the
    # floor's expectation is set by the dither, not by averaging).
    return power[0, 0].mean(axis=0)


def golden_power() -> np.ndarray:
    """The same statistic from the host golden PFB (numpy FFT)."""
    spectra = golden.pfb_channelise(
        make_tone().reshape(-1).astype(np.float32), golden.pfb_window(TAPS, FFT)
    )
    return (np.abs(spectra.astype(np.complex128)) ** 2).mean(axis=0)


def worst_leakage_db(power: np.ndarray) -> float:
    rel_db = 10 * np.log10(power / power[K] + 1e-300)
    mask = np.ones(C, bool)
    mask[K] = False
    return float(rel_db[mask].max())
