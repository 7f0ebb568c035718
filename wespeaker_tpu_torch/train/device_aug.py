"""Reverb and noise augmentation on the card: the device half of
data/pipeline.py::attach_device_aug.

Counterpart of wespeaker_tpu/train/device_aug.py. Upstream applies the
MUSAN/RIR augmentation on CPU dataloader workers (processor.py:421-494),
where scipy's fftconvolve is the host's hot spot. Here the host only picks
the RIR or noise and the SNR; the energy-normalised RIR convolution (a
batched real FFT, torch.fft on cuFFT, as the JAX package uses jnp.fft
outside any kernel), the SNR-scaled mixing and the peak normalise run on
the card in the train step. Reverb matches the host path to FFT rounding
(both are FFT convolutions), noise mixing exactly; RIRs are cut to a fixed
length (1 s by default), which the host path does not do.

`blocks` is the JAX package's: there one global array holds every
process's front-packed block. Here each rank (parallel/mesh.py) augments
its own local batch, one block, so the trainer never passes more.
"""

import torch


def device_augment(wav: torch.Tensor, mode: torch.Tensor, rir: torch.Tensor,
                   noise: torch.Tensor, snr: torch.Tensor,
                   blocks: int = 1) -> torch.Tensor:
    """Apply the augmentation the host chose per sample.

    wav (B, N) f32 in [-1, 1]; mode (B,) int (0 none, 1 reverb, 2 noise);
    rir (cap, R), cap <= B: the host packs the reverb samples into the
    first cap / blocks rows of each of `blocks` equal blocks of the batch
    (pipeline.py::batch_samples; one block in one process), so only those
    rows pay the FFT; noise (B, N); rir and noise f32 in [-1, 1] or the
    store's int16; snr (B,) dB. Returns (B, N) f32. All on one device."""
    if not rir.is_floating_point():
        rir = rir.float() / 32768.0
    if not noise.is_floating_point():
        noise = noise.float() / 32768.0
    b, n = wav.shape
    cap, r = rir.shape
    if b % blocks or cap % blocks:
        raise ValueError(f"batch {b} and rir rows {cap} must split into "
                         f"{blocks} blocks")
    lb, lcap = b // blocks, cap // blocks
    fft_len = 1
    while fft_len < n + r - 1:
        fft_len *= 2

    # reverb: energy-normalised RIR, full convolution cut to n
    rir_n = rir / torch.sqrt((rir * rir).sum(-1, keepdim=True) + 1e-12)
    head = wav.reshape(blocks, lb, n)[:, :lcap].reshape(cap, n)
    spec = torch.fft.rfft(head, fft_len) * torch.fft.rfft(rir_n, fft_len)
    reverbed = torch.fft.irfft(spec, fft_len)[..., :n].to(wav.dtype)
    if cap < b:
        reverbed = torch.cat([
            reverbed.reshape(blocks, lcap, n),
            wav.new_zeros(blocks, lb - lcap, n)], dim=1).reshape(b, n)

    # additive noise at the host-drawn SNR (upstream processor.py:454-476)
    audio_db = 10.0 * torch.log10((wav * wav).mean(-1) + 1e-4)
    noise_db = 10.0 * torch.log10((noise * noise).mean(-1) + 1e-4)
    gain = torch.sqrt(10.0 ** ((audio_db - noise_db - snr) / 10.0))
    noised = wav + gain[:, None] * noise

    m = mode[:, None]
    out = torch.where(m == 1, reverbed, torch.where(m == 2, noised, wav))
    # peak-normalise the augmented rows only (the host path normalises
    # inside the augmentation branch)
    peak = out.abs().amax(-1, keepdim=True) + 1e-4
    return torch.where(m == 0, wav, out / peak)
