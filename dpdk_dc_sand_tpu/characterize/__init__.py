"""Hardware characterisation (L1): measure the busses the pipeline must
saturate (utilities/pcie_bandwidth_tests, tensor_core — SURVEY.md §2.4).

- :mod:`transfer`: host↔device transfer rate (the PCIe rate-test analog).
- :mod:`membw`: host RAM bandwidth thread sweep (memRateTest analog).
- :mod:`tensor_core`: tensor-core dynamic-range probe (fp16 and bf16) and matmul
  rate (tc_dynamic_range analog).
"""

from dpdk_dc_sand_tpu.characterize.transfer import TransferRateTest  # noqa: F401
from dpdk_dc_sand_tpu.characterize.membw import mem_rate_sweep  # noqa: F401
from dpdk_dc_sand_tpu.characterize.tensor_core import (  # noqa: F401
    tc_dynamic_range,
    matmul_rate,
)
