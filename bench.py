"""Throughput of the F+B step at the flagship geometry on one GPU.

Runs ``FBEngine`` (80 antennas, 2 pols, 32,768 channels, 16 beams, 16-tap
PFB, S=256 spectra per step, bf16 beamform operands) on the local GPU,
times warmed steps that each end in ``block_until_ready``, and prints ONE
JSON line naming the device and the card it ran on. There is no fallback:
a configuration that does not fit the card fails, and so does a run
without a GPU.

``vs_baseline`` is throughput divided by the MeerKAT L-band digitiser rate
(1712 Msamples/s per antenna-pol, BeamformerParameters.h:16) — how many
realtime antenna-pol streams one card sustains through the full
channelise+beamform chain.

The benchmark with named cells, golden checks and a trace reduction is
still to be built; ``chip_smoke.py`` holds the correctness checks.

Run: ``python bench.py``
"""

from __future__ import annotations

import json
import statistics
import sys
import time

ADC_RATE_MSPS = 1712.0  # MeerKAT digitiser, Msamples/s per antenna-pol
N_SPECTRA = 256
STEPS = 10


def main() -> int:
    import jax
    import jax.numpy as jnp

    from dpdk_dc_sand_tpu.config import ArrayConfig
    from dpdk_dc_sand_tpu.models import FBEngine
    from dpdk_dc_sand_tpu.utils.compile_cache import enable_compile_cache
    from dpdk_dc_sand_tpu.utils.device import card_info, device_record

    device = device_record()
    if device["platform"] != "gpu":
        print(f"bench: no GPU found ({device})", file=sys.stderr)
        return 1
    enable_compile_cache()
    cfg = ArrayConfig(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
    fb = FBEngine(cfg, n_spectra=N_SPECTRA, precision="bf16")
    adc, cd, fd, ph, dv = fb.example_inputs()
    adc = jax.device_put(adc)
    cd, fd, ph = (jnp.asarray(x) for x in (cd, fd, ph))
    fb.set_beam_delays(dv)
    fb.step(adc, cd, fd, ph).block_until_ready()  # compile + warm
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        fb.step(adc, cd, fd, ph).block_until_ready()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    samples = cfg.n_ants * cfg.n_pols * N_SPECTRA * cfg.fft_size
    value = samples / step_s / 1e6
    record = {
        "metric": (
            "PFB+beamform step throughput "
            f"({cfg.n_ants} ant x {cfg.n_channels} chan x {cfg.n_beams} "
            f"beams, {cfg.n_taps}-tap PFB, S={N_SPECTRA}, bf16 beamform)"
        ),
        "value": round(value, 1),
        "unit": "Msamples/s/card",
        "vs_baseline": round(value / ADC_RATE_MSPS, 2),
        "step_ms_median": round(step_s * 1e3, 3),
        "steps": STEPS,
        "device": device,
        "card": card_info(),
    }
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
