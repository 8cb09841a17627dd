"""Distributed F+B pipeline over a ("ant", "time") mesh via shard_map.

The three reference parallelism mechanisms (SURVEY.md §2.7) become three
XLA collectives inside one jitted step:

1. **Overlap-save halo exchange** (time-block split of the sample stream,
   the reference's BeamformerParameters.h:44-51 blocking): each time shard
   receives the last ``(n_taps−1)·fft_size`` samples of its left neighbour
   via ``lax.ppermute`` before the PFB FIR. The exchange is circular — in
   steady-state streaming, shard 0's halo is the previous chunk's tail,
   which lives on the last shard.
2. **Distributed corner turn** (the xeng_id channel split,
   coeff_generator.py:49-53): ``lax.all_to_all`` over the "time" axis
   swaps spectra-sharding for channel-sharding — each device ends up with
   all time samples of its channel slice, exactly what a multicast
   subscription gave an X-engine in the reference.
3. **Antenna-sum reduction** (the warp-shuffle tree,
   BeamformerKernels.cu:318-341): antennas are sharded over "ant"; each
   device beamforms its antenna subset and ``lax.psum`` over "ant"
   completes the coherent sum across the device interconnect.

Coarse delay is an ingest-side concern (the host feed aligns whole-sample
offsets before sharding, as the NIC/chunking layer did in the reference);
fine delay and fringe phase are applied in-shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.golden.pfb import pfb_window
from dpdk_dc_sand_tpu.models.fbengine import _coeff_blocks
from dpdk_dc_sand_tpu.ops.beamform import beamform_planes
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_key
from dpdk_dc_sand_tpu.ops.correlate import correlate_planes
from dpdk_dc_sand_tpu.ops.delay import apply_fine_delay
from dpdk_dc_sand_tpu.ops.pfb import pfb_channelise
from dpdk_dc_sand_tpu.ops.requant import requantise


class ShardedFBEngine:
    """F+B pipeline sharded over a 2D ``("ant", "time")`` mesh.

    Parameters
    ----------
    cfg:
        System configuration. ``cfg.n_ants`` must divide by the "ant" axis
        size; ``cfg.n_channels`` and ``n_spectra`` by the "time" axis size;
        ``n_spectra // time_size ≥ cfg.n_taps − 1`` so one neighbour's halo
        suffices.
    mesh:
        Mesh from :func:`dpdk_dc_sand_tpu.parallel.make_mesh`.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        mesh: Mesh,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        emit_visibilities: bool = False,
        scatter_beams: bool = False,
        emit_planes: bool = False,
        ici_chunks: int | str = "auto",
    ) -> None:
        ant_size = mesh.shape["ant"]
        time_size = mesh.shape["time"]
        if cfg.n_ants % ant_size:
            raise ValueError("n_ants must divide the ant mesh axis")
        if cfg.n_channels % time_size or n_spectra % time_size:
            raise ValueError("n_channels and n_spectra must divide the time axis")
        if n_spectra // time_size < cfg.n_taps - 1:
            raise ValueError("time shards thinner than the FIR halo")
        if scatter_beams and cfg.n_beams % ant_size:
            raise ValueError("scatter_beams needs n_beams divisible by the ant axis")
        if emit_planes and (emit_visibilities or scatter_beams):
            raise ValueError("emit_planes excludes the B/X stages")
        if ici_chunks == "auto":
            # The largest k in {8, 4, 2} that divides the per-device
            # spectra count, so the F->B collective/compute interleave is
            # on wherever it applies. 1 (off) on a single-device mesh —
            # no collectives to hide — and in the emit modes the
            # interleave doesn't cover.
            per_dev = n_spectra // max(time_size, 1)
            ici_chunks = 1
            if (
                ant_size * time_size > 1
                and not (emit_planes or emit_visibilities)
            ):
                for k in (8, 4, 2):
                    if per_dev % k == 0:
                        ici_chunks = k
                        break
        self.ici_chunks = int(ici_chunks)
        if self.ici_chunks < 1:
            raise ValueError("ici_chunks must be >= 1")
        if self.ici_chunks > 1 and (n_spectra // max(time_size, 1)) % (
            self.ici_chunks
        ):
            raise ValueError(
                "ici_chunks must divide the per-device spectra count "
                f"({n_spectra // max(time_size, 1)})"
            )
        if self.ici_chunks > 1 and (emit_planes or emit_visibilities):
            raise ValueError(
                "ici_chunks interleaving applies to the F→B step only"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.n_spectra = n_spectra
        self.emit_visibilities = emit_visibilities
        self.emit_planes = emit_planes
        self.scatter_beams = scatter_beams
        self.window = jnp.asarray(np.asarray(pfb_window(cfg.n_taps, cfg.fft_size)))

        halo_len = (cfg.n_taps - 1) * cfg.fft_size
        body = functools.partial(
            _sharded_fb_body,
            window=self.window,
            cfg=cfg,
            time_size=time_size,
            halo_len=halo_len,
            quant_scale=quant_scale,
            precision=precision,
            emit_visibilities=emit_visibilities,
            scatter_beams=scatter_beams,
            emit_planes=emit_planes,
            ici_chunks=self.ici_chunks,
        )
        # With scatter_beams the antenna reduction is a reduce_scatter
        # (psum_scatter): half the interconnect bytes of the all-reduce and the
        # dump stays beam-sharded over "ant" — each device owns
        # n_beams/ant_size beams of its channel slice.
        beam_out = P(None, "time", None, "ant" if scatter_beams else None, None)
        if emit_planes:
            # Channel-sharded int8 (re, im) planes — the distributed
            # F-engine product (what an X/B engine would ingest off the
            # multicast fabric in the reference deployment).
            out_specs = (P("ant", None, None, "time"),) * 2
        elif emit_visibilities:
            out_specs = (beam_out, P("time", None, None), P("time", None, None))
        else:
            out_specs = beam_out
        sharded = shard_map(
            body,
            mesh=mesh,
            in_specs=(
                P("ant", None, "time"),  # adc [A, P, N]
                P("ant"),  # frac_delays [A]
                P("ant"),  # phases [A]
                P("time", None, "ant"),  # cos [C, B, A]
                P("time", None, "ant"),  # sin [C, B, A]
            ),
            out_specs=out_specs,
            check_vma=False,
        )

        # Steering planes are regenerated only on delay updates (the
        # 256-accumulation reuse cadence) and enter the step pre-sharded.
        # Same generator as the single-chip engine (_coeff_blocks →
        # ops.steering_coeffs): one copy of the rotation math, with the
        # delay/phase-rate time extrapolation and ?beam-weights folding
        # (BeamformerKernels.cu:121-189; corr3_servlet.py:140-153).
        self._coeff_fn = jax.jit(
            functools.partial(_coeff_blocks, cfg=cfg),
            out_shardings=(
                NamedSharding(mesh, P("time", None, "ant")),
            ) * 2,
        )
        self._coeffs = None
        self._coeff_key = None
        self._step = jax.jit(sharded)
        self.sample_sharding = NamedSharding(mesh, P("ant", None, "time"))
        self.beam_sharding = NamedSharding(mesh, beam_out)

    @property
    def samples_in(self) -> int:
        """Global ADC samples per step (history arrives via the halo)."""
        return self.n_spectra * self.cfg.fft_size

    def __call__(
        self,
        adc: jax.Array,
        frac_delays: jax.Array,
        phases: jax.Array,
        delay_vals: jax.Array,
        ant_weights=None,
        t_s: float = 0.0,
    ) -> jax.Array:
        """One distributed step.

        adc ``[n_ants, n_pols, samples_in]`` int8 (coarse-aligned);
        frac_delays/phases ``[n_ants]`` f32; delay_vals ``[beam][ant][4]``.
        Returns ``[n_pols, n_channels, n_spectra, n_beams, 2]`` f32 beams,
        channel-sharded over the "time" mesh axis.
        """
        self.set_beam_delays(delay_vals, ant_weights=ant_weights, t_s=t_s)
        cos, sin = self._coeffs
        return self._step(adc, frac_delays, phases, cos, sin)

    def set_beam_delays(self, delay_vals, ant_weights=None, t_s: float = 0.0) -> None:
        """(Re)generate sharded steering planes from delay polynomials.

        Same contract as :meth:`FBEngine.set_beam_delays`: ``t_s`` seconds
        past the polynomial epoch extrapolates the solution via the
        delay/phase rates (traced — advancing time never recompiles);
        ``ant_weights`` folds per-antenna magnitudes into the planes (the
        servlet's ``?beam-weights`` fan-out contract)."""
        key = steering_key(delay_vals, ant_weights, t_s)
        if self._coeffs is None or key != self._coeff_key:
            w = (
                jnp.ones(self.cfg.n_ants, jnp.float32)
                if ant_weights is None
                else jnp.asarray(ant_weights, jnp.float32)
            )
            self._coeffs = self._coeff_fn(
                jnp.asarray(delay_vals), w, jnp.float32(t_s)
            )
            self._coeff_key = key

    def example_inputs(self, seed: int = 2021):
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        adc = rng.integers(
            -64, 64, size=(cfg.n_ants, cfg.n_pols, self.samples_in), dtype=np.int8
        )
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return adc, fd, ph, dv


def _sharded_fb_body(
    adc_l: jax.Array,  # [A_loc, P, n_loc]
    frac_l: jax.Array,  # [A_loc]
    phase_l: jax.Array,  # [A_loc]
    cos_l: jax.Array,  # [C_loc, B, A_loc]
    sin_l: jax.Array,
    *,
    window: jax.Array,
    cfg: ArrayConfig,
    time_size: int,
    halo_len: int,
    quant_scale: float,
    precision: str,
    emit_visibilities: bool = False,
    scatter_beams: bool = False,
    emit_planes: bool = False,
    ici_chunks: int = 1,
) -> jax.Array:
    # 1. Overlap-save halo: previous time shard's tail (circular).
    perm = [(i, (i + 1) % time_size) for i in range(time_size)]
    halo = lax.ppermute(adc_l[..., -halo_len:], "time", perm)
    ext = jnp.concatenate([halo, adc_l], axis=-1)

    # 2. Local F-stage. Each shard channelises the full band for its
    # time slice, so no channel offset here.
    spectra = pfb_channelise(
        ext, window, n_channels=cfg.n_channels
    )  # [A_loc, P, S_loc, C]
    with jax.named_scope("fine_delay_requant"):
        re, im = apply_fine_delay(
            jnp.real(spectra),
            jnp.imag(spectra),
            frac_l[:, None],
            phase_l[:, None],
            n_channels=cfg.n_channels,
        )
        # (re, im) stay separate int8 planes through the F→B handoff, as
        # in the single-device engine.
        qr = requantise(re, quant_scale)  # [A_loc, P, S_loc, C] int8
        qi = requantise(im, quant_scale)

    # 3+4. Distributed corner turn (spectra-sharding -> channel-sharding)
    # then partial beamform over local antennas and the antenna-axis
    # collective: all-reduce (psum) for replicated beams, or
    # reduce-scatter (psum_scatter over the beam axis) — the warp-shuffle
    # tree of BeamformerKernels.cu:318-341 across devices.
    def turn(qr_c, qi_c):
        a = lax.all_to_all(
            qr_c, "time", split_axis=3, concat_axis=2, tiled=True
        )
        b = lax.all_to_all(
            qi_c, "time", split_axis=3, concat_axis=2, tiled=True
        )
        return a, b

    def b_stage(ar, ai):
        # -> (pre, pim) partial beams [P, C_loc, S, B] for one spectra
        # sub-block, before the antenna reduction.
        xr_c = jnp.transpose(ar, (1, 3, 2, 0))
        xi_c = jnp.transpose(ai, (1, 3, 2, 0))
        return beamform_planes(xr_c, xi_c, cos_l, sin_l, precision)

    def reduce_beams(pre, pim):
        if scatter_beams:
            pre = lax.psum_scatter(
                pre, "ant", scatter_dimension=3, tiled=True
            )
            pim = lax.psum_scatter(
                pim, "ant", scatter_dimension=3, tiled=True
            )
        else:
            pre = lax.psum(pre, "ant")
            pim = lax.psum(pim, "ant")
        return pre, pim

    if ici_chunks > 1 and not emit_planes and not emit_visibilities:
        # Collective/compute interleave: the local SPECTRA axis is split
        # into sub-blocks, each corner-turned, beamformed and reduced
        # independently — spectra chunking keeps channel ownership (and
        # hence the steering-plane sharding and output layout) exactly
        # as in the monolithic step, so the results are bit-identical.
        # The dependence structure lets XLA's latency-hiding scheduler
        # run chunk j+1's all_to_all and chunk j-1's psum concurrently
        # with chunk j's B-stage compute instead of serialising one
        # monolithic collective against the whole step.
        s_loc = qr.shape[2]
        per = s_loc // ici_chunks
        parts = []
        for j in range(ici_chunks):
            sl = slice(j * per, (j + 1) * per)
            ar, ai = turn(qr[:, :, sl], qi[:, :, sl])
            parts.append(b_stage(ar, ai))
        reduced = [reduce_beams(pre, pim) for pre, pim in parts]

        def order(chunks):
            # Chunk j's gathered spectra are device-major [(d, i'), …];
            # the monolithic order is (d, j, i'). One stacked reshape
            # restores it (a single fused copy over the beams).
            p, c, _, b = chunks[0].shape
            stacked = jnp.stack(
                [x.reshape(p, c, time_size, per, b) for x in chunks],
                axis=3,
            )  # [P, C_loc, T, k, per, B]
            return stacked.reshape(p, c, time_size * ici_chunks * per, b)

        pre = order([r[0] for r in reduced])
        pim = order([r[1] for r in reduced])
        return jnp.stack([pre, pim], axis=-1)

    ar, ai = turn(qr, qi)
    if emit_planes:
        # Distributed F-engine product: [A_loc, P, S_full, C_loc] int8
        # (re, im) planes, channel-sharded — ready for SPEAD egress.
        return ar, ai

    pre, pim = b_stage(ar, ai)
    pre, pim = reduce_beams(pre, pim)
    beams = jnp.stack([pre, pim], axis=-1)
    if not emit_visibilities:
        return beams

    # 5. X stage: correlation needs all antenna pairs, so gather the
    # channel slice's voltages across the "ant" axis (the unavoidable
    # all-pairs traffic), then integrate the local channels.
    xr = jnp.transpose(ar, (1, 3, 2, 0))
    xi = jnp.transpose(ai, (1, 3, 2, 0))
    fr = lax.all_gather(xr, "ant", axis=3, tiled=True)
    fi = lax.all_gather(xi, "ant", axis=3, tiled=True)
    p, c_loc, s_full, a_full = fr.shape
    cr = jnp.transpose(fr, (1, 2, 3, 0)).reshape(c_loc, s_full, a_full * p)
    ci = jnp.transpose(fi, (1, 2, 3, 0)).reshape(c_loc, s_full, a_full * p)
    vre, vim = correlate_planes(cr, ci, precision)
    return beams, vre, vim
