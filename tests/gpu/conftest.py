"""On-card tests: marked ``gpu``, run on an NVIDIA GPU.

Run them on the card with::

    JAX_PLATFORMS=cuda python -m pytest tests/gpu -m gpu

(``chip_smoke.py`` runs the same tests in its own process, after its
phases.) Elsewhere every test here skips with a reason, decided inside
the ``gpu`` fixture at run time — never at import or collection — so every
pytest worker collects the same tests.
"""

import importlib.util
from pathlib import Path

import pytest


@pytest.fixture(scope="session")
def gpu():
    """The GPU the tests run on; skips when there is none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            f"needs a GPU backend, found {jax.default_backend()!r}; run "
            "JAX_PLATFORMS=cuda python -m pytest tests/gpu -m gpu on the card"
        )
    return jax.devices()[0]


@pytest.fixture(scope="session")
def chan_common():
    """``tests/qualification/chan_common.py``, loaded by path: a package
    named ``tests`` installed elsewhere would shadow ``tests.qualification``."""
    path = Path(__file__).parents[1] / "qualification" / "chan_common.py"
    spec = importlib.util.spec_from_file_location("chan_common", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
