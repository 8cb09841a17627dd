"""Engine models (L3 of the layer map): composed, jitted DSP pipelines.

The reference's ``OperationSequence`` chains ops on one command queue with
aliased intermediate buffers (beamform_op_sequence.py:142-156); here the
same composition is function composition inside a single ``jax.jit`` — XLA
fuses the stages and the "compound slots" fall out as fusion temporaries
that never touch HBM.
"""

from dpdk_dc_sand_tpu.models.bengine import BeamformPipeline  # noqa: F401
from dpdk_dc_sand_tpu.models.fengine import FEngine  # noqa: F401
from dpdk_dc_sand_tpu.models.fbengine import FBEngine  # noqa: F401
from dpdk_dc_sand_tpu.models.xengine import (  # noqa: F401
    VisibilityAccumulator,
    XEngine,
)
from dpdk_dc_sand_tpu.models.fxbengine import FXBEngine  # noqa: F401
