"""Helpers around the engines: the int8 code budget, the compile cache,
profiling, device records, the benchmark's refusal, UDP pacing and the
Pallas teaching example."""

import contextlib
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dpdk_dc_sand_tpu.golden.chain import check_codes, code_mismatch

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- codes
def test_check_codes_accepts_rare_one_code_flips():
    want = np.zeros((10, 1000), np.int8)
    got = want.copy()
    got[0, :5] = 1
    assert check_codes(got, want) == (1, 5 / want.size)


def test_check_codes_rejects_a_two_code_difference():
    want = np.zeros((4, 100), np.int8)
    got = want.copy()
    got[2, 7] = -2
    with pytest.raises(AssertionError, match="up to 2"):
        check_codes(got, want)


def test_check_codes_rejects_frequent_one_code_flips():
    want = np.zeros(1000, np.int8)
    got = want.copy()
    got[:3] = 1
    assert code_mismatch(got, want) == (1, 3e-3)
    with pytest.raises(AssertionError, match="limit 0.002"):
        check_codes(got, want)


def test_check_codes_rejects_shape_mismatch():
    with pytest.raises(AssertionError, match="shape"):
        check_codes(np.zeros((2, 3), np.int8), np.zeros((3, 2), np.int8))


# ---------------------------------------------------------------- cache
def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    import jax

    from dpdk_dc_sand_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_defaults_to_the_repo(monkeypatch):
    import jax

    from dpdk_dc_sand_tpu.utils.compile_cache import (
        REPO_CACHE_DIR,
        enable_compile_cache,
    )

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert REPO_CACHE_DIR == str(REPO / ".jax_cache")


def test_repo_cache_dir_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# ------------------------------------------------------------ profiling
def test_trace_raises_when_the_profiler_fails(monkeypatch, tmp_path):
    import jax

    from dpdk_dc_sand_tpu.utils.profiling import trace

    @contextlib.contextmanager
    def broken(log_dir):
        raise RuntimeError("no profiler here")
        yield

    monkeypatch.setattr(jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="no profiler"):
        with trace(str(tmp_path)):
            pass


def test_annotate_raises_when_the_profiler_fails(monkeypatch):
    import jax

    from dpdk_dc_sand_tpu.utils.profiling import annotate

    def broken(name):
        raise RuntimeError("no annotations here")

    monkeypatch.setattr(jax.profiler, "TraceAnnotation", broken)
    with pytest.raises(RuntimeError, match="no annotations"):
        with annotate("x"):
            pass


def test_latest_xplane_raises_on_an_empty_dir(tmp_path):
    from dpdk_dc_sand_tpu.utils.profiling import latest_xplane

    with pytest.raises(FileNotFoundError):
        latest_xplane(str(tmp_path))


def _traced_fb_step(tmp_path):
    from dpdk_dc_sand_tpu.config import ArrayConfig
    from dpdk_dc_sand_tpu.models import FBEngine
    from dpdk_dc_sand_tpu.utils.profiling import latest_xplane, trace

    cfg = ArrayConfig(n_ants=4, n_channels=64, n_beams=2, n_taps=4)
    fb = FBEngine(cfg, n_spectra=8)
    adc, cd, fd, ph, dv = fb.example_inputs()
    fb.set_beam_delays(dv)
    args = (adc, cd, fd, ph, fb._coeff_blocks)
    step = fb._step.lower(*args).compile()
    step(*args).block_until_ready()
    with trace(str(tmp_path)) as d:
        step(*args).block_until_ready()
    return latest_xplane(d), step.as_text()


def test_stage_device_times_attributes_the_stages(tmp_path):
    from dpdk_dc_sand_tpu.models.fbengine import STAGES
    from dpdk_dc_sand_tpu.utils.profiling import stage_device_times

    path, hlo = _traced_fb_step(tmp_path)
    totals, kernels = stage_device_times(path, hlo, STAGES, "/host:CPU")
    assert list(totals)[-1] == "other"
    for label in list(totals)[:-1]:
        parts = label.split("+")
        # A joint label names stages in pipeline order.
        assert parts == [s for s in STAGES if s in parts], label
    assert set(totals) == set(kernels)
    for stage in ("fir", "fft", "beamform", "fine_delay_requant"):
        ms = sum(v for k, v in totals.items() if stage in k.split("+"))
        assert ms > 0, stage
    assert totals["fft"] > 0 and kernels["fft"]


_JOINT_HLO = """\
HloModule jit_step, is_scheduled=true

%inner (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %neg = f32[4]{0} negate(%p), metadata={op_name="jit(step)/corner_turn/neg"}
}

%fused_computation (p0: f32[4]) -> f32[4] {
  %p0 = f32[4]{0} parameter(0)
  %mul = f32[4]{0} multiply(%p0, %p0), metadata={op_name="jit(step)/fine_delay_requant/mul"}
  ROOT %call = f32[4]{0} call(%mul), to_apply=%inner, metadata={op_name="jit(step)/beamform/call"}
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %fft.1 = f32[4]{0} negate(%x), metadata={op_name="jit(step)/jit(pfb)/fft/jit(fft)/fft"}
  %copy.2 = f32[4]{0} copy(%fft.1), metadata={op_name="jit(step)/jit(pfb)/slice"}
  ROOT %fusion = f32[4]{0} fusion(%copy.2), kind=kLoop, calls=%fused_computation, metadata={op_name="jit(step)/beamform/dot"}
}
"""


def test_hlo_op_stages_labels_a_fusion_with_every_stage_it_holds():
    from dpdk_dc_sand_tpu.models.fbengine import STAGES
    from dpdk_dc_sand_tpu.utils.profiling import hlo_op_stages

    got = hlo_op_stages(_JOINT_HLO, STAGES)
    assert got["fft.1"] == "fft"
    assert got["mul"] == "fine_delay_requant"
    assert got["call"] == "corner_turn+beamform"  # through to_apply
    assert got["fusion"] == "fine_delay_requant+corner_turn+beamform"
    assert "copy.2" not in got and "x" not in got  # outside every stage


def test_stage_device_times_rejects_a_module_not_in_the_trace(tmp_path):
    from dpdk_dc_sand_tpu.utils.profiling import stage_device_times

    path, hlo = _traced_fb_step(tmp_path)
    with pytest.raises(ValueError, match="no events"):
        stage_device_times(
            path, hlo.replace("HloModule ", "HloModule other_", 1),
            ("fir",), "/host:CPU",
        )


# --------------------------------------------------------------- device
def test_device_record_names_the_platform():
    from dpdk_dc_sand_tpu.utils.device import device_record

    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1 and rec["kind"]


def test_card_info_raises_without_nvidia_smi(monkeypatch, tmp_path):
    from dpdk_dc_sand_tpu.utils.device import card_info

    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises((FileNotFoundError, subprocess.CalledProcessError)):
        card_info()


def test_bench_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert "no GPU" in res.stderr and '"value"' not in res.stdout


# ------------------------------------------------------------------ udp
def test_udp_sender_pace_bounds_the_rate():
    from dpdk_dc_sand_tpu.stream import Chunk, ChunkRing, UdpReceiver, UdpSender

    ring = ChunkRing(4, (1 << 20) + 16)
    rx = UdpReceiver(("127.0.0.1", 0), ring).start()
    tx = UdpSender(("127.0.0.1", rx.port), pace_gbps=0.1)
    payload = np.arange(1 << 20, dtype=np.uint32).view(np.uint8)[: 1 << 20]
    try:
        t0 = time.monotonic()
        tx.send_chunk(Chunk(payload=payload, seq=0))
        elapsed = time.monotonic() - t0
        # 8 Mbit at 0.1 Gbps: no faster than ~80 ms (last partial batch
        # of 64 packets is unpaced).
        assert elapsed >= 0.07, elapsed
        deadline = time.monotonic() + 10
        got = None
        while got is None and time.monotonic() < deadline:
            got = ring.acquire_read()
            time.sleep(0.01)
        assert got is not None
        view, seq = got
        assert seq == 0
        np.testing.assert_array_equal(UdpReceiver.unpack(view).payload, payload)
    finally:
        tx.close()
        rx.stop()


@pytest.mark.parametrize("pace", [0.0, -1.0])
def test_udp_sender_rejects_a_bad_pace(pace):
    from dpdk_dc_sand_tpu.stream import UdpSender

    with pytest.raises(ValueError, match="pace"):
        UdpSender(("127.0.0.1", 9), pace_gbps=pace)


# ------------------------------------------------------------- examples
def _vector_add_module():
    path = REPO / "examples" / "vector_add_pallas.py"
    spec = importlib.util.spec_from_file_location("vector_add_pallas", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [1024, 8192])
def test_vector_add_triton_route_interpreted(n):
    import jax.numpy as jnp

    va = _vector_add_module()
    x = jnp.arange(n, dtype=jnp.float32)
    y = jnp.full(n, 0.5, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(va.vector_add(x, y, interpret=True)), np.asarray(x + y)
    )


def test_vector_add_rejects_a_ragged_length():
    import jax.numpy as jnp

    va = _vector_add_module()
    x = jnp.zeros(1000, jnp.float32)
    with pytest.raises(ValueError, match="multiple"):
        va.vector_add(x, x, interpret=True)
