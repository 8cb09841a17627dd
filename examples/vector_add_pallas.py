"""Teaching example: vector add as a Pallas kernel on the Triton route.

The ``cpp_example``/``pycuda_example`` analog (VectorAddTest.cu,
pycuda_example/vector_add.py): allocate big vectors, add on the
accelerator, verify on the host, report stage timings with the
:class:`PipelineTest` harness. Demonstrates the minimal ``pallas_call``
pattern for a GPU — one program per block, ``backend="triton"`` — plus
the harness every real op benchmark uses. ``interpret=True`` runs the
same kernel through the Pallas interpreter (the CPU tests do).

Run on a GPU: ``python examples/vector_add_pallas.py [n_elements]``;
on the CPU: ``python examples/vector_add_pallas.py [n_elements] --interpret``.
"""

import sys

import numpy as np

BLOCK = 1024


def vector_add(x, y, interpret: bool = False):
    """``x + y`` for 1-D arrays whose length is a multiple of ``BLOCK``."""
    import jax
    from jax.experimental import pallas as pl

    def kernel(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] + y_ref[...]

    n = x.shape[0]
    if n % BLOCK:
        raise ValueError(f"length {n} is not a multiple of {BLOCK}")
    spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(n // BLOCK,),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        backend="triton",
        interpret=interpret,
    )(x, y)


def main(n: int = 1 << 22, interpret: bool = False) -> None:
    from dpdk_dc_sand_tpu.utils import PipelineTest

    class VectorAddTest(PipelineTest):
        name = "vector-add"

        def simulate_input(self):
            rng = np.random.default_rng(2021)
            return {
                "x": rng.normal(size=n).astype(np.float32),
                "y": rng.normal(size=n).astype(np.float32),
            }

        def run_kernel(self, device):
            import functools

            import jax

            add = jax.jit(functools.partial(vector_add, interpret=interpret))
            return {"sum": add(device["x"], device["y"])}

        def verify_output(self, host_in, host_out):
            return bool(
                np.allclose(host_out["sum"], host_in["x"] + host_in["y"])
            )

    times = VectorAddTest().run_test(iters=3)
    print(times.report())


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--interpret"]
    main(int(args[0]) if args else 1 << 22, "--interpret" in sys.argv[1:])
