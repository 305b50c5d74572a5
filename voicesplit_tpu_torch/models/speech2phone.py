"""Speech2Phone speaker encoder, the reference's third embedding source
(counterpart of `voicesplit_tpu/models/speech2phone.py`).

The reference's notebook (`notebooks/Speech2Phone-ExtractSpeakerEmbeddings.ipynb`,
tflearn) takes the MFCC ``[13, 216]`` of a 5 s segment at 22.05 kHz through
``fully_connected(40, activation='crelu')``; the CReLU output is the
embedding (CReLU concatenates relu(x) and relu(-x): 80 features, the
``emb_dim 80`` of the reference config).  Its dropout layers are no-ops at
inference.

- `librosa_mfcc`: the frontend (librosa's default MFCC), host numpy/scipy.
- `Speech2PhoneEncoder`: flatten (tflearn's row-major order) → Linear(2808,
  40) → CReLU; the one matrix product is the device work.
- `load_speech2phone_weights`: an ``.npz`` / dict with ``FullyConnected/W``
  ``[2808, 40]`` and ``FullyConnected/b`` ``[40]`` (a tflearn export), or a
  torch ``.pt`` of the same two arrays → the encoder's state dict.
- `speech2phone_embedding`: the notebook's extraction (silence trim, short
  clips looped past 5 s, 5 s windows at 1 s hops, mean over windows).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from voicesplit_tpu_torch.dsp.audio_io import resample
from voicesplit_tpu_torch.dsp.mel import mel_filterbank

SAMPLE_RATE = 22050  # the notebook loads with librosa sr=22050 (cell 12)
N_MFCC = 13
N_FRAMES = 216  # 1 + (5*22050)//512: tflearn's fixed input [13, 216]
SEGMENT_SECONDS = 5
STEP_SECONDS = 1
HIDDEN = 40
EMB_DIM = 2 * HIDDEN  # CReLU doubles the features


def librosa_mfcc(
    wav: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    n_mfcc: int = N_MFCC,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
) -> np.ndarray:
    """librosa's default MFCC ``[n_mfcc, T]``: centered STFT (reflect pad
    n_fft // 2), periodic Hann window, power spectrogram, Slaney mel
    filterbank, ``power_to_db(ref=1, amin=1e-10, top_db=80)``, orthonormal
    DCT-II over the mel axis.  Host numpy/scipy."""
    from scipy.fft import dct

    wav = np.asarray(wav, np.float32).reshape(-1)
    pad = n_fft // 2
    if wav.size < pad + 1:  # too short even to reflect-pad: zero-extend
        wav = np.concatenate([wav, np.zeros(pad + 1 - wav.size, np.float32)])
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (wav.size - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)  # periodic hann
    frames = wav[idx] * window[None, :]
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, F]
    fb = mel_filterbank(sample_rate, n_fft, n_mels)  # [n_mels, F] slaney
    mel = power @ fb.T  # [T, n_mels]
    logmel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 80.0)  # top_db=80
    mfcc = dct(logmel, type=2, axis=-1, norm="ortho")[:, :n_mfcc]
    return mfcc.T.astype(np.float32)  # [n_mfcc, T]


def crelu(x: torch.Tensor) -> torch.Tensor:
    """``tf.nn.crelu``: concat(relu(x), relu(-x)) on the last axis."""
    return torch.cat([torch.relu(x), torch.relu(-x)], dim=-1)


class Speech2PhoneEncoder(nn.Module):
    """MFCC ``[B, 13, 216]`` → 80-d embedding (CReLU of a 40-unit dense
    layer).  The flatten is tflearn's row-major reshape (index = mfcc_row ·
    216 + frame), the layout of the original ``FullyConnected/W [2808, 40]``
    (``fc.weight`` is its transpose)."""

    def __init__(self, hidden: int = HIDDEN):
        super().__init__()
        self.fc = nn.Linear(N_MFCC * N_FRAMES, hidden)

    def forward(self, mfcc: torch.Tensor) -> torch.Tensor:
        return crelu(self.fc(mfcc.reshape(mfcc.shape[0], -1)))


def load_speech2phone_weights(
    source: Union[str, Mapping[str, object]],
) -> Dict[str, torch.Tensor]:
    """A Speech2Phone export → `Speech2PhoneEncoder`'s state dict.

    ``source`` is a path to an ``.npz`` / ``.npy`` / ``.pt`` or a loaded
    mapping.  Keys are matched case-insensitively on their last part
    (``w`` / ``weight`` / ``kernel`` and ``b`` / ``bias``), so tflearn's
    ``FullyConnected/W:0`` and a plain ``{"W", "b"}`` both load; the shapes
    must be the published checkpoint's ``[2808, H]`` and ``[H]``."""
    if isinstance(source, str):
        if source.endswith(".npz") or source.endswith(".npy"):
            source = dict(np.load(source, allow_pickle=True))
            if len(source) == 1 and next(iter(source)).startswith("arr_"):
                # np.save of a dict: a 0-d object array
                source = next(iter(source.values())).item()
        else:
            payload = torch.load(source, map_location="cpu", weights_only=False)
            source = payload.get("model_state", payload)

    def norm(k: str) -> str:
        k = k.split("/")[-1].split(".")[-1]
        return k.split(":")[0].lower()

    arrays = {
        norm(k): (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in source.items()
    }
    w = arrays.get("w", arrays.get("weight", arrays.get("kernel")))
    b = arrays.get("b", arrays.get("bias"))
    if w is None or b is None:
        raise ValueError(
            f"no FullyConnected W/b pair in keys {sorted(arrays)}: not a Speech2Phone export"
        )
    w = np.asarray(w, np.float32)
    b = np.asarray(b, np.float32).reshape(-1)
    if w.ndim != 2 or w.shape[0] != N_MFCC * N_FRAMES or w.shape[1] != b.size:
        raise ValueError(
            f"Speech2Phone FC expects W [{N_MFCC * N_FRAMES}, H] and b [H]; "
            f"got {w.shape} / {b.shape}"
        )
    return {"fc.weight": torch.from_numpy(np.ascontiguousarray(w.T)), "fc.bias": torch.from_numpy(b)}


def trim_silence_dbfs(
    wav: np.ndarray, sample_rate: int, threshold_dbfs: float = -50.0, chunk_ms: int = 10,
) -> np.ndarray:
    """pydub-style leading and trailing silence trim (notebook cell 6): the
    first and last 10 ms chunk louder than `threshold_dbfs` (20·log10 of the
    RMS against full scale) bound what is kept; an all-silent clip gives an
    empty array (the notebook skips those files)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    n = max(1, int(sample_rate * chunk_ms / 1000))
    n_chunks = wav.size // n
    if n_chunks == 0:
        return wav.copy()
    rms = np.sqrt(np.mean(wav[: n_chunks * n].reshape(n_chunks, n) ** 2, axis=-1))
    dbfs = 20.0 * np.log10(np.maximum(rms, 1e-12))
    loud = np.flatnonzero(dbfs > threshold_dbfs)
    if loud.size == 0:
        return wav[:0]
    start = loud[0] * n
    end = min(wav.size, (loud[-1] + 1) * n)
    return wav[start:end]


@torch.inference_mode()
def speech2phone_embedding(
    encoder: Speech2PhoneEncoder, wav: np.ndarray, sample_rate: int
) -> np.ndarray:
    """The notebook's extraction → 80-d embedding: trim silence; a clip whose
    whole seconds are fewer than 5 gets the original clip appended until
    they exceed 5 (cell 12); 5 s windows at 1 s hops while the window ends
    within the whole seconds; MFCC and encode each (one batch on the
    encoder's device); the mean over windows.  An all-silent clip gives the
    ``[0]`` sentinel that the dataset layer filters out."""
    wav = trim_silence_dbfs(np.asarray(wav, np.float32), sample_rate)
    if wav.size == 0:
        return np.array([0], np.float32)
    if sample_rate != SAMPLE_RATE:
        wav = resample(wav, sample_rate, SAMPLE_RATE)
    seg = SEGMENT_SECONDS * SAMPLE_RATE
    if int(wav.size / SAMPLE_RATE) < SEGMENT_SECONDS:
        aux = wav
        while int(aux.size / SAMPLE_RATE) <= SEGMENT_SECONDS:
            aux = np.concatenate([aux, wav])
        wav = aux
    dur_s = int(wav.size / SAMPLE_RATE)
    starts = range(0, dur_s - SEGMENT_SECONDS + 1, STEP_SECONDS)
    mfccs = np.stack(
        [librosa_mfcc(wav[s * SAMPLE_RATE : s * SAMPLE_RATE + seg])[:, :N_FRAMES] for s in starts]
    )  # [n_win, 13, 216]
    dev = encoder.fc.weight.device
    embs = encoder(torch.as_tensor(mfccs, device=dev)).float().cpu().numpy()
    return embs.mean(axis=0).astype(np.float32)
