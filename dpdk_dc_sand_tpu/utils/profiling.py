"""Profiler hooks — the analog of the reference's baked-in profiling aids
(SURVEY.md §5.1: CUDA events in the harness, nvcc -lineinfo).

:func:`trace` and :func:`annotate` wrap ``jax.profiler``; a backend that
cannot trace raises instead of silently producing no profile.
:func:`stage_device_times` reduces a trace to device time per named stage
(the engines open one ``jax.named_scope`` per stage, see
:data:`dpdk_dc_sand_tpu.models.fbengine.STAGES`).
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
from typing import Dict, Iterable, Iterator, Tuple

# Lines the profiler derives from the device's own event lines; counting
# them too would count a kernel twice.
_DERIVED_LINES = frozenset(
    ("XLA Modules", "XLA Ops", "Async XLA Ops", "Steps", "Framework Ops",
     "Framework Name Scope", "Source code", "XLA TraceMe")
)

# The HLO module's text: a computation opens at column 0
# ("%fused_computation.2 (...) -> ... {", "ENTRY %main.10 (...) {"); its
# instructions are indented ("  ROOT %fusion.1 = f32[...] fusion(...)").
# An instruction's metadata op_name is the jax name stack, e.g.
# "jit(f)/jit(main)/fir/add"; "calls=" / "to_apply=" name what it calls.
_HLO_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_HLO_INSTR = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_HLO_OP_NAME = re.compile(r"metadata=\{[^}]*op_name=\"([^\"]*)\"")
_HLO_CALLS = re.compile(
    r"(?:calls|to_apply|body|condition|branch_computations)=(\{[^}]*\}|%?[\w.\-]+)"
)
_HLO_NAME = re.compile(r"%?([\w.\-]+)")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a profiler trace of the enclosed block into ``log_dir``.

    Yields ``log_dir``; the ``.xplane.pb`` file lands under
    ``<log_dir>/plugins/profile/<run>/`` (see :func:`latest_xplane`).
    """
    import jax

    with jax.profiler.trace(log_dir):
        yield log_dir


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed host region in profiler traces."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def latest_xplane(log_dir: str) -> str:
    """Path of the newest ``.xplane.pb`` under ``log_dir``."""
    found = glob.glob(
        os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not found:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return max(found, key=os.path.getmtime)


def hlo_op_stages(hlo_text: str, stages: Iterable[str]) -> Dict[str, str]:
    """Map each instruction of a compiled HLO module to its stage label.

    An instruction belongs to the innermost of ``stages`` that appears as
    a component of its metadata ``op_name``. A fusion (or any instruction
    that calls a computation) also belongs to the stages of every
    instruction it calls, so a fusion that XLA built across stages gets a
    joint label, the stages joined by ``+`` in the order of ``stages``
    (e.g. ``"fine_delay_requant+corner_turn+beamform"``). Instructions
    outside every stage are left out.
    """
    stages = tuple(stages)
    own: Dict[str, set] = {}  # instruction -> stages of its own op_name
    calls: Dict[str, list] = {}  # instruction -> computations it calls
    body: Dict[str, list] = {}  # computation -> its instructions
    comp = None
    for line in hlo_text.splitlines():
        head = _HLO_COMPUTATION.match(line)
        if head:
            comp = head.group(1)
            body[comp] = []
            continue
        m = _HLO_INSTR.match(line)
        if not m or comp is None:
            continue
        name = m.group(1)
        body[comp].append(name)
        op = _HLO_OP_NAME.search(line)
        hits = [p for p in op.group(1).split("/") if p in stages] if op else []
        own[name] = set(hits[-1:])
        calls[name] = [
            c for group in _HLO_CALLS.findall(line)
            for c in _HLO_NAME.findall(group)
        ]

    comp_stages: Dict[str, set] = {}

    def of_comp(c):
        if c not in comp_stages:
            comp_stages[c] = set()  # guards against a cycle
            comp_stages[c] = set().union(*(of_instr(i) for i in body.get(c, ())))
        return comp_stages[c]

    def of_instr(i):
        return own[i].union(*(of_comp(c) for c in calls[i]))

    out = {}
    for name in own:
        found = of_instr(name)
        if found:
            out[name] = "+".join(s for s in stages if s in found)
    return out


def stage_device_times(
    xplane_path: str,
    hlo_text: str,
    stages: Iterable[str],
    plane_prefix: str = "/device:",
) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """Device time in ms per stage of one compiled module in a trace.

    ``hlo_text`` is the compiled module's text (``compiled.as_text()``);
    its module name selects the trace events, and :func:`hlo_op_stages`
    maps each event's ``hlo_op`` to a stage label — joint, such as
    ``"coarse_delay+fir"``, for a fusion XLA built across stages. Events
    of that module on planes whose name starts with ``plane_prefix`` (the
    devices) are summed per label; the rest of the module's device time
    goes to ``"other"``. A stage that appears in no label has no row: XLA
    left none of its ops under its name (a transpose, say, folded into the
    layout of the next op, whose name it then carries).

    Returns ``(ms per label, {label: {kernel name: ms}})``, labels in the
    order of their first stage — the second says which kernels (cuFFT,
    cuBLAS, XLA fusions, ...) ran under a label.
    """
    from jax.profiler import ProfileData

    stages = tuple(stages)
    m = re.search(r"HloModule\s+([\w.\-]+)", hlo_text)
    if not m:
        raise ValueError("hlo_text has no HloModule header")
    module = m.group(1)
    op_stage = hlo_op_stages(hlo_text, stages)
    totals: Dict[str, float] = {"other": 0.0}
    kernels: Dict[str, Dict[str, float]] = {"other": {}}
    n_events = 0
    seen = set()
    data = ProfileData.from_file(xplane_path)
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line.name in _DERIVED_LINES:
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                if stats.get("hlo_module") != module:
                    seen.add(str(stats.get("hlo_module")))
                    continue
                n_events += 1
                # A kernel inside a CUDA graph carries the graph's
                # hlo_op; an XLA fusion kernel is named after its fusion.
                stage = op_stage.get(
                    str(stats.get("hlo_op")), op_stage.get(ev.name, "other")
                )
                ms = ev.duration_ns / 1e6
                totals[stage] = totals.get(stage, 0.0) + ms
                per = kernels.setdefault(stage, {})
                per[ev.name] = per.get(ev.name, 0.0) + ms
    if not n_events:
        raise ValueError(
            f"no events of module {module!r} on planes {plane_prefix}*; "
            f"modules seen: {sorted(seen)[:10]}"
        )
    def order(label):
        parts = label.split("+")
        if parts[0] not in stages:  # "other" goes last
            return (len(stages), 0)
        return (stages.index(parts[0]), len(parts))

    labels = sorted(totals, key=order)
    return {k: totals[k] for k in labels}, {k: kernels[k] for k in labels}
