"""Whisper-parity log-mel frontend on the device.

Counterpart of ``macaw_llm_tpu/audio/mel.py``, through the same windowed
real-DFT basis: frames are a strided view of the reflect-padded waveform
and the STFT is one matmul against the [400, 402] cos/sin basis.
Numerics of whisper's audio.py: n_fft=400, hop=160, periodic Hann,
center=True reflect pad, power of frames [:-1], 80-bin slaney mel,
log10(clamp 1e-10), floor at max - 8, (x + 4) / 4.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 400
HOP_LENGTH = 160
SAMPLE_RATE = 16000
N_MELS = 80
CHUNK_LENGTH = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH  # 480000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(
            np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=4)
def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(np.array(0.0)),
                          _hz_to_mel(np.array(sr / 2.0)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=2)
def dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Hann-windowed real-DFT basis [n_fft, 2 * (n_fft // 2 + 1)]:
    cos columns, then sin columns."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    return (basis * window[:, None]).astype(np.float32)


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """whisper.pad_or_trim: zero-pad or clip the last axis to ``length``."""
    n = audio.shape[-1]
    if n > length:
        return audio[..., :length]
    if n < length:
        return torch.nn.functional.pad(audio, (0, length - n))
    return audio


def log_mel_spectrogram(audio: torch.Tensor,
                        n_mels: int = N_MELS) -> torch.Tensor:
    """[B, 480000] waveform -> [B, n_mels, 3000] Whisper log-mel (fp32)."""
    if audio.dim() == 1:
        audio = audio[None]
    x = F.pad(audio.float()[:, None], (N_FFT // 2, N_FFT // 2),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)              # [B, T+1, 400]
    basis = torch.from_numpy(dft_basis(N_FFT)).to(x.device)
    spec = frames @ basis                                 # [B, T+1, 402]
    nb = N_FFT // 2 + 1
    re, im = spec[:, :-1, :nb], spec[:, :-1, nb:]         # drop last frame
    magnitudes = re * re + im * im
    filters = torch.from_numpy(mel_filterbank(n_mels=n_mels)).to(x.device)
    mel_spec = torch.einsum("mf,btf->bmt", filters, magnitudes)
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    log_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, log_max - 8.0)
    return (log_spec + 4.0) / 4.0
