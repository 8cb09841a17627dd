"""chip_smoke.py rehearsed on the CPU, and its refusals.

Each phase runs here at the rehearsal widths (``Smoke(rehearse=True)``);
the ``four`` phase takes the first 4 of the suite's 8 virtual CPU
devices. The script itself runs as a child process for what only a whole
run shows: its last line, and its exit code without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    sm = chip_smoke.Smoke(rehearse=True)
    sm.trace_root = str(tmp_path_factory.mktemp("traces"))
    return sm


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_device_phase_rehearsed(smoke, capsys, monkeypatch):
    # Leave this process's compile cache off.
    import dpdk_dc_sand_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "(test: off)")
    rec = smoke.device()
    assert rec["platform"] == "cpu"
    assert "compile cache" in capsys.readouterr().out


def test_fb_phase_rehearsed(smoke, capsys):
    s = smoke.fb()
    assert s == smoke.s_candidates[0]
    out = capsys.readouterr().out
    assert "F planes vs golden" in out and "device time per stage" in out


def test_fb_bf16_phase_rehearsed(smoke, capsys):
    smoke.fb_bf16(smoke.s_candidates[-1])
    assert "bf16 beams vs f32 beams" in capsys.readouterr().out


def test_fxb_phase_rehearsed(smoke, capsys):
    smoke.fxb()
    assert "bit for bit" in capsys.readouterr().out


def test_node_phase_rehearsed(smoke, capsys):
    smoke.node()
    out = capsys.readouterr().out
    assert "heaps lost=0" in out and "equal FBEngine" in out


def test_four_phase_rehearsed(smoke, capsys):
    smoke.four()
    out = capsys.readouterr().out
    assert "spans 4 devices" in out and "all-to-all" in out


def test_rehearsal_last_line_names_the_cpu():
    res = _run(["--rehearse"], REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}
    }


def test_exits_nonzero_without_gpu():
    res = _run([], REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["--rehearse"], tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
