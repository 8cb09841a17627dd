"""Channelisation qualification test (Given/When/Then over the real op).

Implements ``features/channelisation.feature`` against the device F-engine
path, with evidence threaded through the report fixture — the
bdd_experiment pattern (step_defs/test_channelisation.py:8-33) without the
pytest-bdd dependency (unavailable here).
"""

import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FEngine

LEAKAGE_SPEC_DB = -62.0


def _tone_adc(fe: FEngine, channel: float, amp=100.0, dtype=np.int8):
    """CW test tone. int8 emulates the digitiser (its quantisation
    harmonics sit near -50 dBc and dominate any filter below them);
    float32 injects an ideal tone for filter-response measurements."""
    n = np.arange(fe.samples_in + 8)
    tone = amp * np.cos(2 * np.pi * channel * n / fe.cfg.fft_size)
    return np.broadcast_to(
        tone.astype(dtype), (fe.cfg.n_ants, fe.cfg.n_pols, n.size)
    ).copy()


def _channelise(fe: FEngine, adc):
    z = np.zeros(fe.cfg.n_ants, np.float32)
    out = np.asarray(fe(adc, np.zeros(fe.cfg.n_ants, np.int32), z, z))
    power = out[..., 0].astype(np.float64) ** 2 + out[..., 1] ** 2
    return power[0, 0, 4]  # one antenna/pol, a middle spectrum


def test_cw_tone_at_channel_centre(report):
    report.step(
        "Given", "an F-engine configured with 128 channels and a 16-tap PFB"
    )
    cfg = ArrayConfig(n_ants=1, n_channels=128, n_taps=16)
    # Filter-response qualification measures the float path: the int8
    # transport format's per-bin quantisation floor (~-40 dB) cannot
    # express a -62 dB bound (its placement behaviour is covered below).
    fe = FEngine(
        cfg, n_spectra=8, quant_scale=1.0,
        quantise_output=False,
    )

    k = 37
    report.step(
        "When",
        f"an ideal (unquantised) CW tone at the centre of channel {k} "
        "is channelised",
    )
    power = _channelise(fe, _tone_adc(fe, k, dtype=np.float32))

    peak = int(np.argmax(power))
    report.step(
        "Then", "the peak response lands in the tone's channel", peak_channel=peak
    )
    assert peak == k

    rel_db = 10 * np.log10(power / power[k] + 1e-300)
    mask = np.ones(cfg.n_channels, bool)
    mask[k] = False
    worst = float(rel_db[mask].max())
    report.step(
        "And",
        "the response in every other channel is at least 62 dB down",
        worst_leakage_db=round(worst, 2),
        spec_db=LEAKAGE_SPEC_DB,
    )
    report.detail_entry("leakage_margin_db", round(LEAKAGE_SPEC_DB - worst, 2))
    assert worst <= LEAKAGE_SPEC_DB


def test_cw_tone_sweep(report):
    report.step(
        "Given", "an F-engine configured with 128 channels and a 16-tap PFB"
    )
    cfg = ArrayConfig(n_ants=1, n_channels=128, n_taps=16)
    fe = FEngine(cfg, n_spectra=8, quant_scale=1.0)
    channels = [3, 17, 64, 100, 126]
    report.step("When", f"tones at channel centres {channels} are channelised")
    peaks = []
    for k in channels:
        power = _channelise(fe, _tone_adc(fe, k))
        peaks.append(int(np.argmax(power)))
    report.step("Then", "each peak lands in its own channel", peaks=peaks)
    assert peaks == channels
