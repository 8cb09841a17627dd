#!/usr/bin/env python3
"""Smoke run of the instrument on one NVIDIA GPU, at flagship width.

Drives the main path through the entry points a user calls and checks
every result against the host golden models:

- ``device``: what JAX runs on, the card's name and power limit, the
  compile cache in use.
- ``fb``: ``FBEngine`` at 80 antennas × 32,768 channels × 16 beams, 16-tap
  PFB, f32 beams. The spectra count S is the largest power of two up to
  256 whose step fits the card (``memory_analysis``). The F stage's int8
  planes are held to the golden F chain (±1 code, rarely), the beams to
  the golden beamform of the device's own planes (1e-4 × max|beam|), and
  one warmed step is traced for device time per stage.
- ``fb_bf16``: the same engine with bf16 beamform operands, against the
  f32 beams at the bf16 budget (relative RMS < 1e-2, max < 1e-1).
- ``fxb``: ``FXBEngine`` with int8 visibilities; a channel block must
  equal the golden correlation of the device's own int8 planes exactly.
- ``node``: ``EngineNode`` served over loopback UDP (SPEAD-64-48 heaps
  from the repository's sender, paced); every chunk's beams must equal
  ``FBEngine`` on the same chunk, with no heap lost.
- ``gpu_tests``: the ``gpu``-marked tests, in this same process.

``--four`` runs only the channel-sharded ``ShardedFBEngine`` on a 2×2 mesh
of four cards against single-card ``FBEngine``. ``--rehearse`` runs every
phase on the CPU at small widths. Without a GPU (and without
``--rehearse``) the script exits non-zero and prints no result.

One JAX process holds the card for the whole run; the last line of
standard output is ``{"ok": true, "device": {...}}``.

Run: ``python chip_smoke.py`` / ``python chip_smoke.py --four`` /
``python chip_smoke.py --rehearse [--four]``.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 2021
FLAGSHIP = dict(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
SMALL = dict(n_ants=8, n_channels=512, n_beams=4, n_taps=8)
#: Golden comparisons cover the first spectra of a step (host cost).
GOLDEN_SPECTRA = 4
#: Channels of the exact visibility comparison.
VIS_BLOCK = 256
#: Share of the card's memory a step may plan for; the rest is left for
#: cuFFT's workspace, which memory_analysis does not count.
FIT_SHARE = 0.85
#: Loopback UDP pace of the node phase: below what the receiver thread
#: drains with the engine running beside it.
NODE_PACE_GBPS = 0.4
NODE_CHUNKS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def gb(n: float) -> str:
    return f"{n / 1e9:.2f} GB"


def run_phase(name, fn, *args, **kwargs):
    log(f"[{name}] start")
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
    return out


class Smoke:
    def __init__(self, rehearse: bool):
        import jax

        from dpdk_dc_sand_tpu.config import ArrayConfig

        self.jax = jax
        self.rehearse = rehearse
        self.cfg = ArrayConfig(**(SMALL if rehearse else FLAGSHIP))
        self.s_candidates = (32, 16, 8) if rehearse else (256, 128, 64, 32)
        self.node_spectra = 8 if rehearse else 32
        self.platform = jax.devices()[0].platform
        self.plane_prefix = "/host:CPU" if self.platform == "cpu" else "/device:"
        self.card = "none (CPU rehearsal)"
        self.trace_root = os.path.join(REPO, "chiprun_out", "chip_smoke")
        self.planes = {}  # S -> the device plane slices of _planes()

    # ------------------------------------------------------------------
    def device(self):
        from dpdk_dc_sand_tpu.utils.compile_cache import enable_compile_cache
        from dpdk_dc_sand_tpu.utils.device import card_info, device_record

        rec = device_record()
        log(f"devices: platform={rec['platform']} kind={rec['kind']} "
            f"count={rec['count']}")
        log(f"jax {self.jax.__version__}; compile cache: {enable_compile_cache()}")
        if not self.rehearse:
            lines = card_info()
            for line in lines:
                log(f"card: {line}")
            self.card = lines[0]
        log("beam f32 precision: lax.Precision.HIGHEST (no TF32)")
        return rec

    # ------------------------------------------------------------------
    def _fits(self, compiled, label):
        ma = compiled.memory_analysis()
        need = (
            ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes
        )
        log(f"{label} memory_analysis: arguments {gb(ma.argument_size_in_bytes)}"
            f", outputs {gb(ma.output_size_in_bytes)}, temps "
            f"{gb(ma.temp_size_in_bytes)}, total {gb(need)}")
        stats = self.jax.devices()[0].memory_stats()
        if not stats or "bytes_limit" not in stats:
            log(f"{label}: device memory limit not reported")
            return True
        limit = stats["bytes_limit"]
        log(f"{label}: device memory limit {gb(limit)}")
        return need <= FIT_SHARE * limit

    def _choose(self, make, label):
        """(S, engine, compiled step) for the largest S that fits."""
        import jax
        import jax.numpy as jnp

        cfg = self.cfg
        for s in self.s_candidates:
            eng = make(s)
            eng.set_beam_delays(self._delays(cfg)[3])
            adc = jax.ShapeDtypeStruct(
                (cfg.n_ants, cfg.n_pols, eng.samples_in + 64), jnp.int8
            )
            cd = jax.ShapeDtypeStruct((cfg.n_ants,), jnp.int32)
            f = jax.ShapeDtypeStruct((cfg.n_ants,), jnp.float32)
            t0 = time.perf_counter()
            compiled = eng._step.lower(adc, cd, f, f, eng._coeff_blocks).compile()
            log(f"{label} S={s}: compiled in {time.perf_counter() - t0:.1f} s")
            if self._fits(compiled, f"{label} S={s}"):
                if s != self.s_candidates[0]:
                    log(f"{label}: S={self.s_candidates[0]} does not fit the "
                        f"card; using S={s} (spectra are depth; widths uncut)")
                log(f"{label}: S={s} at {cfg.n_ants} ant x {cfg.n_channels} "
                    f"chan x {cfg.n_beams} beams x {cfg.n_taps} taps")
                return s, eng, compiled
            del compiled, eng
            gc.collect()
        raise RuntimeError(f"{label}: no spectra count fits the card")

    def _delays(self, cfg):
        rng = np.random.default_rng(SEED)
        cd = rng.integers(0, 64, cfg.n_ants).astype(np.int32)
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return cd, fd, ph, dv

    def _adc(self, n):
        """Seeded int8 ADC stream [A, P, n] made on the device."""
        import jax
        import jax.numpy as jnp

        cfg = self.cfg

        @functools.partial(jax.jit, static_argnums=1)
        def make(key, shape):
            bits = jax.random.bits(key, shape, jnp.uint8)
            return (bits >> 1).astype(jnp.int8) - jnp.int8(64)

        return make(jax.random.key(SEED), (cfg.n_ants, cfg.n_pols, n))

    def _planes(self, s, adc, delays):
        """Device int8 planes of the F stage, sliced on the device:
        (first GOLDEN_SPECTRA spectra, all channels) and (all spectra,
        the first VIS_BLOCK channels), each [A, P, S', C', 2]."""
        if s in self.planes:
            return self.planes[s]
        import jax
        import jax.numpy as jnp

        from dpdk_dc_sand_tpu.models import FBEngine
        from dpdk_dc_sand_tpu.models.fbengine import _f_stage

        cfg = self.cfg
        fb = FBEngine(cfg, n_spectra=s)
        cb = min(VIS_BLOCK, cfg.n_channels)

        @jax.jit
        def f(adc, cd, fd, ph):
            qr, qi = _f_stage(
                adc, cd, fd, ph, window=fb.window, cfg=cfg, n_spectra=s,
                quant_scale=fb.quant_scale,
            )
            head = jnp.stack(
                [qr[:, :, :GOLDEN_SPECTRA], qi[:, :, :GOLDEN_SPECTRA]], -1
            )
            block = jnp.stack([qr[..., :cb], qi[..., :cb]], -1)
            return head, block

        cd, fd, ph, _ = delays
        head, block = f(adc, cd, fd, ph)
        self.planes = {s: (np.asarray(head), np.asarray(block))}
        return self.planes[s]

    # ------------------------------------------------------------------
    def fb(self):
        import jax.numpy as jnp

        from dpdk_dc_sand_tpu import golden
        from dpdk_dc_sand_tpu.golden.chain import check_codes, f_planes
        from dpdk_dc_sand_tpu.models import FBEngine
        from dpdk_dc_sand_tpu.models.fbengine import STAGES

        cfg = self.cfg
        s, fb, step = self._choose(
            lambda s: FBEngine(cfg, n_spectra=s), "fb"
        )
        delays = self._delays(cfg)
        cd, fd, ph, dv = delays
        adc = self._adc(fb.samples_in + 64)
        args = (adc, cd, fd, ph, fb._coeff_blocks)
        beams = step(*args).block_until_ready()  # warm
        t0 = time.perf_counter()
        beams = step(*args).block_until_ready()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"fb step (informational, one warmed step): {ms:.2f} ms; "
            f"card: {self.card}")
        assert beams.shape == (cfg.n_pols, cfg.n_channels, s, cfg.n_beams, 2)
        assert bool(jnp.isfinite(beams).all())

        # F stage: device int8 planes vs the golden F chain.
        head, _ = self._planes(s, adc, delays)
        need = (GOLDEN_SPECTRA + cfg.n_taps - 1) * cfg.fft_size + 64
        adc_head = np.asarray(adc[..., :need])
        want = f_planes(
            adc_head, cd, fd, ph, n_taps=cfg.n_taps,
            n_channels=cfg.n_channels, n_spectra=GOLDEN_SPECTRA,
            quant_scale=fb.quant_scale,
        )
        worst, frac = check_codes(head, want)
        log(f"F planes vs golden ({GOLDEN_SPECTRA} spectra, all antennas, "
            f"pols, channels): max {worst} code, {frac:.3g} of codes differ "
            f"(limits 1 code, 2e-3): ok")

        # B stage: f32 beams vs golden beamform of the device's own planes.
        x = (head[..., 0].astype(np.float32) + 1j * head[..., 1]).transpose(
            1, 3, 2, 0
        )  # [P, C, S', A]
        w = golden.steering_coeffs_complex(
            np.broadcast_to(dv, (cfg.n_channels,) + dv.shape),
            cfg.n_channels, cfg.sample_period,
        )
        want_b = golden.beamform_complex(x, w)  # [P, C, S', B]
        got_b = np.asarray(beams[:, :, :GOLDEN_SPECTRA])
        tol = 1e-4 * float(np.abs(want_b).max())
        err = max(
            float(np.abs(got_b[..., 0] - want_b.real).max()),
            float(np.abs(got_b[..., 1] - want_b.imag).max()),
        )
        log(f"beams vs golden beamform of device planes: max err {err:.4g} "
            f"(limit 1e-4 x max|beam| = {tol:.4g})")
        assert err <= tol, (err, tol)

        self._stage_trace("fb", fb, args, STAGES)
        return s

    def _stage_trace(self, label, eng, args, stages):
        """Device time per stage from a trace of one warmed step.

        Traced from a build of the same step without CUDA graphs: inside
        a graph every kernel carries the graph's name, not its op's. The
        optimised HLO of the step goes beside the trace.
        """
        import jax

        from dpdk_dc_sand_tpu.utils.profiling import (
            latest_xplane,
            stage_device_times,
            trace,
        )

        lowered = eng._step.lower(*args)
        opts = {}
        if self.platform == "gpu":
            opts = {"xla_gpu_enable_command_buffer": ""}
        step = lowered.compile(compiler_options=opts)
        jax.block_until_ready(step(*args))
        os.makedirs(self.trace_root, exist_ok=True)
        with open(os.path.join(self.trace_root, f"{label}_hlo.txt"), "w") as f:
            f.write(step.as_text())
        with trace(os.path.join(self.trace_root, label)) as d:
            jax.block_until_ready(step(*args))
        totals, kernels = stage_device_times(
            latest_xplane(d), step.as_text(), stages, self.plane_prefix
        )
        self._print_stages(label, totals, kernels, stages)

    def _print_stages(self, label, totals, kernels, stages):
        log(f"{label} device time per stage (card: {self.card}; a joint "
            "label a+b is one fusion XLA built across stages):")
        for stage, ms in totals.items():
            top = sorted(kernels[stage].items(), key=lambda kv: -kv[1])[:3]
            names = "; ".join(f"{k[:70]} {v:.2f} ms" for k, v in top)
            log(f"  {stage:>40}: {ms:9.3f} ms  [{names}]")
        log(f"  {'total':>40}: {sum(totals.values()):9.3f} ms")
        covered = {s for lab in totals for s in lab.split("+")}
        for stage in stages:
            if stage not in covered:
                log(f"  {stage}: no kernel under its name (XLA folded its "
                    "ops into the next op's layout)")

    # ------------------------------------------------------------------
    def fb_bf16(self, s):
        import jax.numpy as jnp

        from dpdk_dc_sand_tpu.models import FBEngine

        cfg = self.cfg
        cd, fd, ph, dv = self._delays(cfg)
        f32 = FBEngine(cfg, n_spectra=s)
        b16 = FBEngine(cfg, n_spectra=s, precision="bf16")
        adc = self._adc(f32.samples_in + 64)
        ref = f32(adc, cd, fd, ph, dv)
        got = b16(adc, cd, fd, ph, dv)
        scale = jnp.sqrt(jnp.mean(ref ** 2))
        rms = float(jnp.sqrt(jnp.mean((got - ref) ** 2)) / scale)
        mx = float(jnp.max(jnp.abs(got - ref)) / scale)
        log(f"bf16 beams vs f32 beams at S={s}: relative RMS {rms:.3g} "
            f"(limit 1e-2), max {mx:.3g} (limit 1e-1)")
        assert rms < 1e-2 and mx < 1e-1, (rms, mx)

    # ------------------------------------------------------------------
    def fxb(self):
        import jax.numpy as jnp

        from dpdk_dc_sand_tpu import golden
        from dpdk_dc_sand_tpu.models import FXBEngine
        from dpdk_dc_sand_tpu.models.fbengine import STAGES

        cfg = self.cfg
        s, fxb, step = self._choose(
            lambda s: FXBEngine(cfg, n_spectra=s), "fxb"
        )
        delays = self._delays(cfg)
        cd, fd, ph, _ = delays
        adc = self._adc(fxb.samples_in + 64)
        args = (adc, cd, fd, ph, fxb._coeff_blocks)
        beams, vre, vim = step(*args)
        vre.block_until_ready()
        log(f"fxb visibilities: 2 x {vre.shape} {vre.dtype} "
            f"({gb(2 * vre.size * 4)})")
        _, block = self._planes(s, adc, delays)
        cb = block.shape[-2]
        x = block.transpose(3, 2, 0, 1, 4).reshape(
            cb, s, cfg.n_ants * cfg.n_pols, 2
        )
        want_re, want_im = golden.correlate_planar(x[..., 0], x[..., 1])
        np.testing.assert_array_equal(np.asarray(vre[:cb]), want_re)
        np.testing.assert_array_equal(np.asarray(vim[:cb]), want_im)
        log(f"int8 visibilities, channels 0-{cb - 1}, all {s} spectra: equal "
            "to golden correlation of the device planes bit for bit")
        assert bool(jnp.isfinite(beams).all())

        self._stage_trace("fxb", fxb, args, STAGES + ("correlate",))
        gram = [
            line.strip() for line in step.as_text().splitlines()
            if "correlate" in line and ("custom_call_target" in line
                                        or " dot(" in line)
        ]
        for line in gram[:4]:
            log(f"fxb int8 gram HLO: {line[:200]}")

    # ------------------------------------------------------------------
    def node(self):
        return asyncio.run(self._node())

    async def _node(self):
        from dpdk_dc_sand_tpu.control import Client
        from dpdk_dc_sand_tpu.engine_node import EngineNode

        cfg = self.cfg
        got = {}
        node = EngineNode(
            cfg, n_spectra=self.node_spectra, ring_slots=4,
            on_beams=lambda beams, seq: got.__setitem__(seq, beams),
        )
        cd, fd, ph, dv = self._delays(cfg)
        # Compile the node's step before data flows, so no heap arrives
        # while the processing thread traces.
        node.fb.set_beam_delays(dv, ant_weights=np.ones(cfg.n_ants, np.float32))
        node.fb.step(np.zeros(node.chunk_shape, np.int8), cd, fd, ph)
        await node.start()
        child = None
        try:
            rx = node.attach_udp_ingest(("127.0.0.1", 0))
            client = await Client("127.0.0.1", node.port).connect()
            model = np.stack([cd, fd, ph, np.zeros_like(fd)], -1).ravel()
            await client.request("delay-model", *[float(v) for v in model])
            for b in range(cfg.n_beams):
                await client.request(
                    "beam-delays", b, *[float(v) for v in dv[b].ravel()]
                )
            child = subprocess.Popen(
                [sys.executable, "-c", _SENDER, str(rx.port),
                 json.dumps(list(node.chunk_shape)), str(NODE_CHUNKS),
                 str(NODE_PACE_GBPS)],
                cwd=REPO,
            )
            deadline = time.monotonic() + 600
            while len(got) < NODE_CHUNKS and time.monotonic() < deadline:
                if child.poll() not in (None, 0):
                    raise RuntimeError(f"sender exited {child.returncode}")
                await asyncio.sleep(0.1)
            assert child.wait(timeout=60) == 0
            child = None
            _, inf = await client.request("sensor-value", "chunks-processed")
            processed = int(inf[0].args[4])
            _, inf = await client.request("sensor-value", "chunks-lost")
            lost = int(inf[0].args[4])
            heaps = rx.assembler64.stats
            ring_drops = node.ring.stats()[2]
            log(f"node: chunks-processed={processed} chunks-lost={lost} "
                f"heaps delivered={heaps.consumed} heaps lost={heaps.lost} "
                f"incomplete heaps dropped={rx.assembler64.incomplete_dropped} "
                f"ring drops={ring_drops} at {NODE_PACE_GBPS} Gbps, "
                f"chunk {gb(np.prod(node.chunk_shape))}")
            assert sorted(got) == list(range(NODE_CHUNKS)), sorted(got)
            assert processed == NODE_CHUNKS and lost == 0 and ring_drops == 0
            assert heaps.lost == 0 and rx.assembler64.incomplete_dropped == 0
            await client.close()
        finally:
            if child is not None:
                child.kill()
                child.wait()
            await node.stop()
        rng = np.random.default_rng(SEED)
        for seq in range(NODE_CHUNKS):
            chunk = rng.integers(-64, 64, size=node.chunk_shape, dtype=np.int8)
            want = np.asarray(node.fb.step(chunk, cd, fd, ph))
            np.testing.assert_array_equal(got[seq], want)
        log(f"node: beams of all {NODE_CHUNKS} chunks equal FBEngine on the "
            "same chunks")

    # ------------------------------------------------------------------
    def gpu_tests(self):
        import pytest

        class Count:
            def __init__(self):
                self.outcomes = []

            def pytest_runtest_logreport(self, report):
                if report.when == "call" or report.outcome != "passed":
                    self.outcomes.append((report.nodeid, report.outcome))

        count = Count()
        rc = pytest.main(
            [os.path.join(REPO, "tests", "gpu"), "-m", "gpu", "-q",
             "-p", "no:cacheprovider", "-rs"],
            plugins=[count],
        )
        passed = sum(o == "passed" for _, o in count.outcomes)
        log(f"gpu tests: {passed} passed of {len(count.outcomes)}, rc={rc}")
        assert int(rc) == 0, rc
        if not self.rehearse:
            assert passed == len(count.outcomes) > 0, count.outcomes

    # ------------------------------------------------------------------
    def four(self):
        import jax

        from dpdk_dc_sand_tpu.models import FBEngine
        from dpdk_dc_sand_tpu.parallel import (
            ShardedFBEngine,
            make_mesh,
            scatter_local,
        )
        from dpdk_dc_sand_tpu.utils.profiling import latest_xplane, trace

        cfg = self.cfg
        s = self.s_candidates[0]
        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four needs 4 devices, have {jax.devices()}")
        mesh = make_mesh(4)
        log(f"four: mesh {dict(mesh.shape)} over {len(mesh.devices.flat)} "
            f"devices, S={s}")
        eng = ShardedFBEngine(cfg, mesh, n_spectra=s)
        _, fd, ph, dv = self._delays(cfg)
        rng = np.random.default_rng(SEED)
        adc = rng.integers(
            -64, 64, size=(cfg.n_ants, cfg.n_pols, eng.samples_in),
            dtype=np.int8,
        )

        # Single-card reference first (circular halo: the stream's tail
        # is the first shard's history); its buffers go before the mesh.
        halo = (cfg.n_taps - 1) * cfg.fft_size
        fb = FBEngine(cfg, n_spectra=s)
        ref = fb(
            np.concatenate([adc[..., -halo:], adc], -1),
            np.zeros(cfg.n_ants, np.int32), fd, ph, dv,
        )
        want = np.asarray(ref)
        del ref, fb
        gc.collect()

        adc_d = scatter_local(adc, eng.sample_sharding)
        out = eng(adc_d, fd, ph, dv).block_until_ready()
        log(f"four: output sharding spans {len(out.sharding.device_set)} "
            f"devices, ici_chunks={eng.ici_chunks}")
        assert len(out.sharding.device_set) == 4
        for dev in mesh.devices.flat:
            stats = dev.memory_stats()
            if stats is None:
                log(f"four: {dev}: memory stats not reported")
                continue
            log(f"four: {dev}: peak_bytes_in_use {gb(stats['peak_bytes_in_use'])}")
            assert stats["peak_bytes_in_use"] > 0
        got = np.asarray(out)
        diff = np.abs(got - want)
        rel = 1e-4 * float(np.abs(want).max())
        frac = float(np.count_nonzero(diff > rel)) / diff.size
        log(f"four: sharded vs single-card beams: max diff {diff.max():.4g} "
            f"(limit 2, one int8 code through a unit weight on re and im), "
            f"{frac:.3g} of values beyond 1e-4 x max|beam| (limit 2e-3)")
        assert diff.max() <= 2.0 and frac <= 2e-3, (diff.max(), frac)

        # Traced from a build without CUDA graphs, as in _stage_trace.
        args = (adc_d, fd, ph) + tuple(eng._coeffs)
        opts = {}
        if self.platform == "gpu":
            opts = {"xla_gpu_enable_command_buffer": ""}
        step = eng._step.lower(*args).compile(compiler_options=opts)
        step(*args).block_until_ready()
        with trace(os.path.join(self.trace_root, "four")) as d:
            step(*args).block_until_ready()
        self._print_collectives(latest_xplane(d))

    def _print_collectives(self, path):
        from jax.profiler import ProfileData

        kinds = ("all-to-all", "all-reduce", "reduce-scatter",
                 "collective-permute", "all-gather")
        totals = {k: 0.0 for k in kinds}
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith(self.plane_prefix):
                continue
            for line in plane.lines:
                for ev in line.events:
                    op = str(dict(ev.stats).get("hlo_op", ""))
                    op = op.replace("_", "-")  # "all_to_all.3" on the GPU
                    for k in kinds:
                        if op.startswith(k):
                            totals[k] += ev.duration_ns / 1e6
        for k, ms in totals.items():
            log(f"four: {k} device time {ms:.3f} ms (sum over devices; "
                f"card: {self.card})")


#: The node phase's digitiser: a child process (no JAX) sending seeded
#: chunks as SPEAD-64-48 heaps with the repository's UDP sender.
_SENDER = """
import json, sys
import numpy as np
from dpdk_dc_sand_tpu.stream.chunk import Chunk
from dpdk_dc_sand_tpu.stream.udp import UdpSender
port, shape, n, pace = sys.argv[1:5]
tx = UdpSender(("127.0.0.1", int(port)), wire_format="spead64",
               pace_gbps=float(pace))
rng = np.random.default_rng(%d)
for seq in range(int(n)):
    adc = rng.integers(-64, 64, size=tuple(json.loads(shape)), dtype=np.int8)
    tx.send_chunk(Chunk(payload=adc.ravel().view(np.uint8), seq=seq,
                        timestamp=seq))
tx.close()
""" % SEED


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="only the four-card sharded engine vs one card")
    p.add_argument("--rehearse", action="store_true",
                   help="every phase on the CPU at small widths")
    args = p.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )
    sys.path.insert(0, REPO)
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU found (JAX platform {platform!r})",
              file=sys.stderr)
        return 1
    smoke = Smoke(args.rehearse)
    rec = run_phase("device", smoke.device)
    if args.four:
        run_phase("four", smoke.four)
    else:
        s = run_phase("fb", smoke.fb)
        gc.collect()
        run_phase("fb_bf16", smoke.fb_bf16, s)
        gc.collect()
        run_phase("fxb", smoke.fxb)
        smoke.planes = {}
        gc.collect()
        run_phase("node", smoke.node)
        gc.collect()
        run_phase("gpu_tests", smoke.gpu_tests)
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
