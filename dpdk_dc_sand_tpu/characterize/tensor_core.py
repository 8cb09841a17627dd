"""Tensor-core numeric probing and matmul rate — the tensor_core analog.

``tensor_core/tc_dynamic_range`` asks whether 65000 × 1.5e-5 survives
fp16 tensor-core arithmetic (tc_dynamic_range.py:13-15): 65000 sits just
under fp16's largest finite value and 1.5e-5 is below its smallest normal,
so the small operand loses significand bits. The same question with
bfloat16 operands answers differently: bf16 has fp32's exponent range (no
overflow or subnormal at these values) but only an 8-bit significand.
Both probes accumulate in f32, as the tensor cores do.
"""

from __future__ import annotations

import time
from typing import Dict


_DTYPES = ("float16", "bfloat16", "float32")


def tc_dynamic_range(
    large: float = 65000.0, small: float = 1.5e-5, dtype: str = "bfloat16"
) -> Dict[str, float]:
    """Probe value survival through one matmul with ``dtype`` operands.

    A [16,16] matrix of ``large`` multiplied by a diagonal of ``small``
    should yield exactly ``large*small`` everywhere if the pipeline
    preserves both magnitudes (tc_dynamic_range.cu:6-20 structure).
    """
    import jax
    import jax.numpy as jnp

    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    dt = jnp.dtype(dtype)
    a = jnp.full((16, 16), large, dt)
    b = (jnp.eye(16) * small).astype(dt)
    out = jax.jit(
        lambda a, b: jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )
    )(a, b)
    got = float(out[0, 0])
    expected = large * small
    import numpy as np

    rel_err = abs(got - expected) / abs(expected)
    return {
        "expected": expected,
        "got": got,
        "rel_err": rel_err,
        # fp16/bf16 significand rounding bounds the error near 2^-8
        "survives": float(rel_err < 2 ** -7),
    }


def matmul_rate(
    n: int = 4096, dtype: str = "bfloat16", iters: int = 8
) -> Dict[str, float]:
    """Measured matmul TFLOP/s from a dependent matmul chain.

    Chained (``x ← x@w·eps``) so the backend cannot elide or overlap
    iterations; first call compiles and is excluded.
    """
    import jax
    import jax.numpy as jnp

    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.full((n, n), 0.5, dt)
    w = (jnp.eye(n) * 1.001).astype(dt)

    @jax.jit
    def chain(x):
        def body(i, x):
            return jax.lax.dot_general(
                x, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
            ).astype(dt)

        return jax.lax.fori_loop(0, iters, body, x)

    float(chain(x)[0, 0])  # compile + run
    t0 = time.perf_counter()
    float(chain(x)[0, 0])
    dt_s = time.perf_counter() - t0
    flops = 2 * n**3 * iters
    return {"n": n, "iters": iters, "tflops": flops / dt_s / 1e12}


def main() -> None:
    for dtype in ("float16", "bfloat16"):
        dr = tc_dynamic_range(dtype=dtype)
        print(
            f"dynamic range {dtype}: expected={dr['expected']:.4g} "
            f"got={dr['got']:.4g} rel_err={dr['rel_err']:.3g} "
            f"survives={bool(dr['survives'])}"
        )
    rl = matmul_rate()
    print(f"matmul rate: {rl['tflops']:.1f} TFLOP/s @ n={rl['n']}")


if __name__ == "__main__":
    main()
