"""Characterisation + timing-harness tests (CPU backend)."""

import numpy as np

from dpdk_dc_sand_tpu.characterize import (
    TransferRateTest,
    matmul_rate,
    mem_rate_sweep,
    tc_dynamic_range,
)
from dpdk_dc_sand_tpu.utils import PipelineTest


class TestTimingHarness:
    def test_stage_report_and_verify(self):
        class VectorAdd(PipelineTest):
            """The cpp_example/VectorAddTest analog."""

            def simulate_input(self):
                rng = np.random.default_rng(0)
                return {
                    "a": rng.normal(size=4096).astype(np.float32),
                    "b": rng.normal(size=4096).astype(np.float32),
                }

            def run_kernel(self, device):
                return {"sum": device["a"] + device["b"]}

            def verify_output(self, host_in, host_out):
                return bool(
                    np.allclose(host_out["sum"], host_in["a"] + host_in["b"])
                )

        times = VectorAdd().run_test(iters=2)
        assert times.passed is True
        assert times.kernel_ms >= 0
        report = times.report()
        assert "PASS" in report and "limiting stage" in report

    def test_failure_reported(self):
        class Broken(PipelineTest):
            def simulate_input(self):
                return {"x": np.ones(8, np.float32)}

            def run_kernel(self, device):
                return {"y": device["x"] * 2}

            def verify_output(self, host_in, host_out):
                return bool(np.allclose(host_out["y"], host_in["x"] * 3))

        assert Broken().run_test().passed is False


class TestTransferRate:
    def test_h2d_and_d2h(self):
        for direction in ("h2d", "d2h", "both"):
            t = TransferRateTest(
                frame_bytes=256 * 1024, n_frames=10, direction=direction
            )
            gbps = t.transfer(4)
            assert gbps > 0

    def test_timed_run(self):
        t = TransferRateTest(frame_bytes=128 * 1024, n_frames=10)
        assert t.transfer_for_length_of_time(0.2) > 0


class TestMemBw:
    def test_sweep_shape(self):
        rows = mem_rate_sweep(
            thread_range=(1, 2), bytes_per_thread=16 * 1024 * 1024, seconds=0.05
        )
        assert len(rows) == 2
        for threads, w, r in rows:
            assert w > 0 and r > 0


class TestMxu:
    def test_dynamic_range_f32_survives(self):
        res = tc_dynamic_range(dtype="float32")
        assert res["survives"] == 1.0
        assert res["rel_err"] < 1e-6

    def test_dynamic_range_bf16_within_mantissa(self):
        res = tc_dynamic_range(dtype="bfloat16")
        # bf16 keeps the exponent range; error bounded by significand
        assert res["rel_err"] < 2 ** -7

    def test_dynamic_range_fp16_small_operand_subnormal(self):
        # 65000 stays finite in fp16 (max 65504); 1.5e-5 is subnormal,
        # so it keeps ~8 significand bits: the product survives, rounded.
        res = tc_dynamic_range(dtype="float16")
        assert np.isfinite(res["got"])
        assert 0 < res["rel_err"] < 2 ** -7

    def test_dynamic_range_rejects_unknown_dtype(self):
        import pytest

        with pytest.raises(ValueError, match="dtype"):
            tc_dynamic_range(dtype="int4")

    def test_roofline_runs(self):
        r = matmul_rate(n=256, iters=2)
        assert r["tflops"] > 0


def test_characterize_cli(capsys):
    from dpdk_dc_sand_tpu.characterize.__main__ import main

    main(["-s", "-m", "1", "-M", "1", "-t", "0.05", "--frame-mb", "0.25"])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("threads,mem_write_GBps")
    assert len(lines) == 2
