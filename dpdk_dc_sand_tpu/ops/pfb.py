"""Polyphase-filterbank channeliser (the F-engine core).

The reference's F-engine lived in katfgpu (merge_gpu_repositories/
do_merge.sh:4-10); this implements its contract — multi-tap windowed-sinc
FIR + real FFT with the channelisation acceptance spec of
``bdd_experiment/test/features/channelisation.feature:5-9``.

The FIR is an unrolled tap sum over overlapping frame slices, which XLA
fuses into one loop over the input; the FFT is XLA's real FFT (cuFFT on a
GPU). Each runs under its own ``jax.named_scope`` ("fir", "fft") so a
profiler trace attributes device time to it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dpdk_dc_sand_tpu.golden.pfb import pfb_window  # re-export  # noqa: F401


def _fir_jnp(frames: jax.Array, window: jax.Array, n_spectra: int) -> jax.Array:
    n_taps = window.shape[0]
    f = frames.astype(jnp.float32)
    out = f[..., 0:n_spectra, :] * window[0]
    for tap in range(1, n_taps):
        out = out + f[..., tap : tap + n_spectra, :] * window[tap]
    return out


@jax.jit
def pfb_fir(samples: jax.Array, window: jax.Array) -> jax.Array:
    """Polyphase FIR: ``[..., n]`` real → ``[..., n_spectra, fft_size]`` f32.

    ``n`` must be ``(n_spectra + n_taps − 1) · fft_size``; the first
    ``n_taps − 1`` frames are history (the overlap-save halo exchanged
    between time shards in the distributed pipeline).
    """
    n_taps, fft_size = window.shape
    n = samples.shape[-1]
    if n % fft_size:
        raise ValueError(f"sample count {n} not a multiple of fft_size {fft_size}")
    n_frames = n // fft_size
    n_spectra = n_frames - n_taps + 1
    if n_spectra < 1:
        raise ValueError("need at least n_taps frames of input")
    frames = samples.reshape(*samples.shape[:-1], n_frames, fft_size)
    return _fir_jnp(frames, window.astype(jnp.float32), n_spectra)


@functools.partial(jax.jit, static_argnames=("n_channels",))
def pfb_channelise(
    samples: jax.Array,
    window: jax.Array,
    n_channels: int | None = None,
) -> jax.Array:
    """Full PFB: FIR + rFFT keeping ``fft_size // 2`` channels.

    ``[..., n]`` real → ``[..., n_spectra, n_channels]`` complex64.
    """
    with jax.named_scope("fir"):
        fir = pfb_fir(samples, window)
    if n_channels is None:
        n_channels = window.shape[1] // 2
    with jax.named_scope("fft"):
        spectra = jnp.fft.rfft(fir, axis=-1)
    return spectra[..., :n_channels].astype(jnp.complex64)


def default_window(n_taps: int, fft_size: int) -> jax.Array:
    """Device constant of the canonical Hann-sinc prototype."""
    return jnp.asarray(np.asarray(pfb_window(n_taps, fft_size)))
