"""Host↔device transfer rate test — the CUDA PCIe rate-test analog.

Parity with ``utilities/pcie_bandwidth_tests/pcieRateTest.hpp:16-61`` /
``cudaPcieRateTest``: frames-in-a-ring model, ``transfer(n_frames)`` and
``transfer_for_length_of_time(s)`` returning Gbps, directions h2d / d2h /
bidirectional. The reference pipelines dual CUDA streams with an event
ring (cudaPcieRateTest.cpp:63-123); here jax's async dispatch provides the
overlap and a trailing ``block_until_ready`` closes the timing window.
"""

from __future__ import annotations

import time
from typing import Literal

import numpy as np

Direction = Literal["h2d", "d2h", "both"]


class TransferRateTest:
    """Measure host↔device throughput with a ring of pinned-size frames.

    Parameters mirror the reference defaults: 100 frames × 5 MiB
    (main.cpp:11-13).
    """

    def __init__(
        self,
        frame_bytes: int = 5 * 1024 * 1024,
        n_frames: int = 100,
        direction: Direction = "h2d",
        device=None,
    ) -> None:
        import jax

        self.frame_bytes = frame_bytes
        self.n_frames = n_frames
        self.direction = direction
        self.device = device or jax.devices()[0]
        self._host_frames = [
            np.random.default_rng(i).integers(
                0, 255, frame_bytes, dtype=np.uint8
            )
            for i in range(min(n_frames, 4))
        ]
        self._device_frame = None

    def _put_all(self, n: int):
        import jax

        arrs = []
        for i in range(n):
            arrs.append(
                jax.device_put(
                    self._host_frames[i % len(self._host_frames)], self.device
                )
            )
        jax.block_until_ready(arrs)
        return arrs

    def transfer(self, n_frames: int) -> float:
        """Move ``n_frames`` and return the achieved rate in Gbps."""
        import jax

        if self.direction in ("d2h", "both") and self._device_frame is None:
            self._device_frame = jax.device_put(
                self._host_frames[0], self.device
            )
            jax.block_until_ready(self._device_frame)

        t0 = time.perf_counter()
        moved = 0
        if self.direction in ("h2d", "both"):
            self._put_all(n_frames)
            moved += n_frames * self.frame_bytes
        if self.direction in ("d2h", "both"):
            for _ in range(n_frames):
                np.asarray(self._device_frame)
            moved += n_frames * self.frame_bytes
        dt = time.perf_counter() - t0
        return moved * 8 / dt / 1e9

    def transfer_for_length_of_time(self, seconds: float) -> float:
        """Repeat batches until ``seconds`` elapse; return mean Gbps."""
        batch = max(1, self.n_frames // 10)
        rates = []
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            rates.append(self.transfer(batch))
        return float(np.mean(rates)) if rates else 0.0
