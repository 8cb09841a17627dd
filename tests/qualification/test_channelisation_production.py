"""Channelisation qualification of the engines' own F stage.

Implements ``features/channelisation_production.feature``: the evidence
must cover the F path that ships — the shared F stage of ``FBEngine``,
``FXBEngine`` and ``FEngine`` (coarse delay → tap-sum FIR → XLA real FFT
→ fine delay) — measured on its unquantised f32 output so the int8
transport floor cannot mask the filterbank response. The remaining floor
is the *input* digitiser quantisation (int8 ADC), reported as evidence.
The same measurement runs on the card in ``tests/gpu``.
"""

import numpy as np

from tests.qualification.chan_common import (
    C,
    K,
    LEAKAGE_SPEC_DB,
    TAPS,
    engine_power,
    golden_power,
    worst_leakage_db,
)


def test_production_engine_leakage(report):
    report.step(
        "Given",
        f"the engines' F stage with {C} channels and a {TAPS}-tap PFB",
    )
    report.step(
        "When",
        f"an int8 digitiser CW tone at the centre of channel {K} is "
        "channelised without requantisation",
    )
    power = engine_power()
    peak = int(np.argmax(power))
    report.step(
        "Then", "the peak response lands in the tone's channel",
        peak_channel=peak,
    )
    assert peak == K
    worst = worst_leakage_db(power)
    report.step(
        "And",
        "the response in every other channel is at least 62 dB down",
        worst_leakage_db=round(worst, 2),
        spec_db=LEAKAGE_SPEC_DB,
        note="floor is the int8 ADC input quantisation, not the filterbank",
    )
    report.detail_entry("leakage_margin_db", round(LEAKAGE_SPEC_DB - worst, 2))
    assert worst <= LEAKAGE_SPEC_DB


def test_production_engine_matches_golden_floor(report):
    report.step(
        "Given",
        f"the engines' F stage and the golden PFB, {C} channels, "
        f"{TAPS} taps",
    )
    report.step("When", "both channelise the same tone")
    worst_engine = worst_leakage_db(engine_power())
    worst_golden = worst_leakage_db(golden_power())
    report.step(
        "Then",
        "the device FFT's float32 arithmetic does not lift the leakage "
        "floor above the golden model's",
        worst_engine_db=round(worst_engine, 2),
        worst_golden_db=round(worst_golden, 2),
    )
    assert abs(worst_engine - worst_golden) <= 1.0
    assert worst_engine <= LEAKAGE_SPEC_DB
