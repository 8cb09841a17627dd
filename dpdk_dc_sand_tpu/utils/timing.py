"""Stage-timed benchmark harness — the ``common/UnitTest`` analog.

The reference's C++ ``UnitTest`` template method runs simulate_input →
(event-timed) transfer_HtoD → run_kernel → transfer_DtoH → verify_output
and reports per-stage times, names the limiting bus, and computes the
kernel/PCIe utilisation ratio (common/UnitTest.cpp:28-112). This is the
JAX equivalent: subclass :class:`PipelineTest`, implement the same five
hooks, and ``run_test()`` produces a :class:`StageTimes` report.

Timing notes: device stages are walled with ``block_until_ready`` after a
warm-up iteration so compile time is excluded; pass ``iters > 1`` to
time stages over ``iters`` repeats and average them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import jax


@dataclasses.dataclass
class StageTimes:
    """Per-stage wall times in ms + verdict (UnitTest.cpp:77-112 report)."""

    simulate_ms: float
    h2d_ms: float
    kernel_ms: float
    d2h_ms: float
    verify_ms: float
    passed: Optional[bool]

    @property
    def limiting_stage(self) -> str:
        stages = {
            "h2d": self.h2d_ms,
            "kernel": self.kernel_ms,
            "d2h": self.d2h_ms,
        }
        return max(stages, key=stages.get)

    @property
    def kernel_transfer_ratio(self) -> float:
        """>1 means compute-bound; <1 means the host link dominates."""
        transfer = max(self.h2d_ms + self.d2h_ms, 1e-9)
        return self.kernel_ms / transfer

    def report(self) -> str:
        lines = [
            f"simulate_input : {self.simulate_ms:10.3f} ms",
            f"transfer_h2d   : {self.h2d_ms:10.3f} ms",
            f"run_kernel     : {self.kernel_ms:10.3f} ms",
            f"transfer_d2h   : {self.d2h_ms:10.3f} ms",
            f"verify_output  : {self.verify_ms:10.3f} ms",
            f"limiting stage : {self.limiting_stage}",
            f"kernel/transfer: {self.kernel_transfer_ratio:.2f}",
            f"result         : "
            + {True: "PASS", False: "FAIL", None: "NOT-RUN"}[self.passed],
        ]
        return "\n".join(lines)


class PipelineTest:
    """Template-method benchmark: override the five hooks.

    - :meth:`simulate_input` → host arrays (dict)
    - :meth:`transfer_h2d` → device arrays (dict)
    - :meth:`run_kernel` → device outputs (dict)
    - :meth:`transfer_d2h` → host outputs (dict)
    - :meth:`verify_output` → bool
    """

    name = "pipeline-test"

    def simulate_input(self) -> Dict:
        raise NotImplementedError

    def transfer_h2d(self, host: Dict) -> Dict:
        import jax.numpy as jnp

        return {k: jax.device_put(jnp.asarray(v)) for k, v in host.items()}

    def run_kernel(self, device: Dict) -> Dict:
        raise NotImplementedError

    def transfer_d2h(self, outputs: Dict) -> Dict:
        import numpy as np

        return {k: np.asarray(v) for k, v in outputs.items()}

    def verify_output(self, host_in: Dict, host_out: Dict) -> Optional[bool]:
        return None

    # ------------------------------------------------------------------
    def run_test(self, iters: int = 1, verify: bool = True) -> StageTimes:
        t0 = time.perf_counter()
        host_in = self.simulate_input()
        t_sim = time.perf_counter() - t0

        t0 = time.perf_counter()
        device = self.transfer_h2d(host_in)
        jax.block_until_ready(device)
        t_h2d = time.perf_counter() - t0

        # Warm-up excludes compile time from the kernel stage.
        jax.block_until_ready(self.run_kernel(device))
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = self.run_kernel(device)
        jax.block_until_ready(out)
        t_kernel = (time.perf_counter() - t0) / iters

        t0 = time.perf_counter()
        host_out = self.transfer_d2h(out)
        t_d2h = time.perf_counter() - t0

        t0 = time.perf_counter()
        passed = self.verify_output(host_in, host_out) if verify else None
        t_verify = time.perf_counter() - t0

        return StageTimes(
            simulate_ms=t_sim * 1e3,
            h2d_ms=t_h2d * 1e3,
            kernel_ms=t_kernel * 1e3,
            d2h_ms=t_d2h * 1e3,
            verify_ms=t_verify * 1e3,
            passed=passed,
        )
