"""Shared pytest scaffolding.

Two jobs, mirroring the reference's test strategy (SURVEY.md §4):

1. Default JAX to a virtual 8-device CPU platform so multi-device sharding
   (mesh/psum/ppermute/all_to_all paths) is exercised without accelerator
   hardware. An explicit ``JAX_PLATFORMS`` wins, so the on-card run
   (``JAX_PLATFORMS=cuda python -m pytest tests/gpu -m gpu``) chooses the
   GPU; which tests are collected never depends on the platform.
2. Provide the ``combinations`` marker: parameter sweeps from several value
   lists that by default run only enough combinations to cover every value
   once (with the final, most complex value of every list always paired
   together), expanding to the full Cartesian product under
   ``--all-combinations`` — the reference's pairwise-pruning plugin pattern
   (beamformer/unit_test/conftest.py:17-101).
"""

import os

# Both are read when JAX initialises its backends, which happens after
# this module runs (no test module imports jax before conftest).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import itertools  # noqa: E402

import pytest  # noqa: E402


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers", "combinations(names, *values): test combinations of values"
    )


def pytest_addoption(parser) -> None:
    parser.getgroup("combinations").addoption(
        "--all-combinations",
        action="store_true",
        help="Test the full Cartesian product of parameters",
    )


def _coverage_rows(value_lists: list[list]) -> list[tuple]:
    """Minimal sweep rows covering every value of every list at least once.

    The lists are cycled in lockstep until the longest one is exhausted;
    the final row instead pins every list to its last entry, so the
    (conventionally heaviest) parameters are exercised together. The
    *marker semantics* match the reference's pruning plugin
    (beamformer/unit_test/conftest.py); this table construction is ours.
    """
    n_rows = max(len(vals) for vals in value_lists)
    cycles = [itertools.cycle(vals) for vals in value_lists]
    rows = [tuple(next(c) for c in cycles) for _ in range(n_rows - 1)]
    rows.append(tuple(vals[-1] for vals in value_lists))
    return rows


def pytest_generate_tests(metafunc) -> None:
    full = metafunc.config.option.all_combinations
    for marker in metafunc.definition.iter_markers("combinations"):
        raw_names, *value_lists = marker.args
        if isinstance(raw_names, str):
            names = [n.strip() for n in raw_names.split(",") if n.strip()]
        else:
            names = list(raw_names)
        if len(names) != len(value_lists):
            pytest.fail(
                f"{metafunc.definition.nodeid}: combinations marker got "
                f"{len(names)} names but {len(value_lists)} value lists",
                pytrace=False,
            )
        if not names:
            continue
        if full:
            # Full Cartesian product: stacked parametrize calls multiply.
            for name, vals in zip(names, value_lists):
                metafunc.parametrize(name, vals)
        else:
            metafunc.parametrize(names, _coverage_rows(value_lists))
