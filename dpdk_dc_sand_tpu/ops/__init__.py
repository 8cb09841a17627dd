"""Device ops (L2/L3 of the layer map): jittable pure functions.

Each op here replaces one reference GPU kernel (SURVEY.md §2.1-2.2) with
plain ``jax.numpy``/``lax`` code that XLA compiles for the device. Ops take
runtime arrays plus *static* shape parameters (hashable, jit-cacheable) —
the analog of the reference's per-shape mako/numba JIT specialisation
(prebeamform_reorder.py:107-118).
"""

from dpdk_dc_sand_tpu.ops.coeff_gen import (  # noqa: F401
    steering_coeffs,
    steering_coeff_matrix,
    steering_coeff_blockcat,
    generate_coeff_matrix,
)
from dpdk_dc_sand_tpu.ops.reorder import (  # noqa: F401
    prebeamform_reorder,
    prebeamform_reorder_inverse,
)
from dpdk_dc_sand_tpu.ops.beamform import (  # noqa: F401
    beamform,
    beamform_matrix,
    beamform_planes,
    beamform_planes_folded,
)
from dpdk_dc_sand_tpu.ops.pfb import pfb_fir, pfb_channelise  # noqa: F401
from dpdk_dc_sand_tpu.ops.delay import (  # noqa: F401
    coarse_delay,
    apply_fine_delay,
)
from dpdk_dc_sand_tpu.ops.requant import requantise  # noqa: F401
from dpdk_dc_sand_tpu.ops.correlate import (  # noqa: F401
    correlate,
    correlate_accumulate,
    correlate_planes,
)
