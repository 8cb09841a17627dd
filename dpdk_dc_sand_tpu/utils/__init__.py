"""Shared utilities: stage-timed benchmarking harness, test helpers."""

from dpdk_dc_sand_tpu.utils.timing import PipelineTest, StageTimes  # noqa: F401
from dpdk_dc_sand_tpu.utils.profiling import annotate, trace  # noqa: F401
from dpdk_dc_sand_tpu.utils.compile_cache import enable_compile_cache  # noqa: F401
