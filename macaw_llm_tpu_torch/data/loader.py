"""Media loading for the serving path (counterpart of the ``load_wav``
part of ``macaw_llm_tpu/data/loader.py``; the batch loader and its
prefetch are not ported yet)."""

from __future__ import annotations

import wave

import numpy as np

from macaw_llm_tpu_torch.audio.mel import N_SAMPLES, SAMPLE_RATE


def load_wav(path: str, target_len: int = N_SAMPLES,
             target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """WAV -> fp32 mono waveform at target_rate, padded or trimmed to
    ``target_len`` (30 s). Sources at another rate are resampled by linear
    interpolation.

    Uses the native C++ decoder (native/libmacaw_media.so) when built,
    falling back to the stdlib ``wave`` module."""
    from macaw_llm_tpu_torch.data import native
    if native.available():
        out = native.load_wav(path, target_len, target_rate)
        if out is not None:
            return out
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        sw = w.getsampwidth()
        ch = w.getnchannels()
        rate = w.getframerate()
    if sw == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        audio = np.frombuffer(raw, np.uint8).astype(np.float32) / 128.0 - 1.0
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    if rate != target_rate and rate > 0 and audio.shape[0] > 1:
        n_new = int(round(audio.shape[0] * target_rate / rate))
        audio = np.interp(
            np.arange(n_new, dtype=np.float64) * rate / target_rate,
            np.arange(audio.shape[0], dtype=np.float64),
            audio).astype(np.float32)
    if audio.shape[0] >= target_len:
        return audio[:target_len]
    return np.pad(audio, (0, target_len - audio.shape[0]))
