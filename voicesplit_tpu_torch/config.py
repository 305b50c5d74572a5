"""Typed configuration schema + loaders.

The PyTorch port's own copy of `voicesplit_tpu/config.py`, kept
field-for-field identical so every config under `configs/` loads
unchanged; the port imports nothing of the JAX package.

Mirrors the reference's commented-JSON schema (reference `config.json:1-98`,
loader at `utils/generic_utils.py:560-594`) but as typed dataclasses: the
same sections (model / loss / train_config / test_config / audio with three
backends) with the same field names and defaults, so a reference
`config.json` loads unchanged.  Unlike the reference's AttrDict, unknown
keys are rejected loudly and every field is typed.

Configs serialize to a canonical JSON string that is embedded into
checkpoints (the reference stores `config_str`, `train.py:131`) and can be
re-loaded from that string (`load_config_from_str`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _strip_json_comments(text: str) -> str:
    """Remove ``// ...`` line comments from not-quite-JSON text.

    The reference config files use ``//`` comments (stripped with the same
    regex idea as reference `utils/generic_utils.py:565-573`).  We are
    careful not to strip ``//`` inside string literals (e.g. URLs).
    """
    out = []
    for line in text.splitlines():
        in_str = False
        escaped = False
        cut = len(line)
        for i, ch in enumerate(line):
            if escaped:
                escaped = False
                continue
            if ch == "\\":
                escaped = True
            elif ch == '"':
                in_str = not in_str
            elif ch == "/" and not in_str and i + 1 < len(line) and line[i + 1] == "/":
                cut = i
                break
        out.append(line[:cut])
    return "\n".join(out)


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return d


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


@dataclass
class DatasetFormat:
    """Glob formats used to discover sample triplets (reference `config.json:6-13`)."""

    emb: str = "*-emb.npy"
    mixed: str = "*-mixed.npy"
    target: str = "*-target.npy"
    emb_wav: str = "*-ref_emb.wav"
    target_wav: str = "*-target.wav"
    mixed_wav: str = "*-mixed.wav"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetFormat":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class DatasetConfig:
    train_dir: str = ""
    test_dir: str = ""
    format: DatasetFormat = field(default_factory=DatasetFormat)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetConfig":
        d = dict(_filter_kwargs(cls, d))
        if "format" in d and isinstance(d["format"], dict):
            d["format"] = DatasetFormat.from_dict(d["format"])
        return cls(**d)


@dataclass
class LossConfig:
    """Loss selection (reference `config.json:16-20`)."""

    loss_name: str = "si_snr"  # "si_snr" | "power_law_compression"
    power: float = 0.30
    complex_loss_ratio: float = 0.113  # lambda from arXiv:1811.07030

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LossConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class TrainConfig:
    """Training hyperparameters (reference `config.json:21-32`)."""

    epochs: int = 1000
    learning_rate: float = 1e-2
    optimizer: str = "adam"
    batch_size: int = 2
    seed: int = 42
    num_workers: int = 14
    logs_path: str = "checkpoints/run/"
    reinit_layers: Optional[List[str]] = None
    summary_interval: int = 2
    checkpoint_interval: int = 500
    # --- TPU-native additions (absent in the reference) ---
    compute_dtype: str = "bfloat16"  # dtype of conv/LSTM activations on the MXU
    check_interval: int = 10  # loss-guard + multi-host preemption-agreement
    # cadence (steps), independent of summary_interval: a huge summary
    # interval can no longer delay explosion detection or lose the
    # preemption grace window (ADVICE r1)
    grad_clip_norm: Optional[float] = None
    lr_decay_steps: Optional[int] = None  # cosine-decay horizon (constant
    # lr, the reference behavior, when None)
    lr_decay_alpha: float = 0.05  # final lr fraction of the peak
    weight_decay: float = 0.0  # AdamW decoupled weight decay on matmul
    # kernels (bias/BN-scale excluded); 0 = plain Adam (the reference)
    spec_aug_time: int = 0  # SpecAugment-style input masking of the
    spec_aug_freq: int = 0  # MIXED spec (train only): max mask width in
    spec_aug_n: int = 2  # frames / freq bins, masks per axis.  The mask
    # net sees the corrupted spec; the estimate still multiplies the
    # CLEAN mixture spec (input corruption, not target corruption).
    data_axis: str = "data"  # mesh axis for data parallelism
    model_axis: str = "model"  # mesh axis for model parallelism (wide variant)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class TestConfig:
    batch_size: int = 1
    num_workers: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TestConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class ModelConfig:
    """Mask-network dimensions (reference `config.json:37-42`)."""

    lstm_dim: int = 400
    fc1_dim: int = 600
    fc2_dim: int = 601  # == num_freq of the active audio backend
    emb_dim: int = 256  # 256 for GE2E, 80 for Speech2Phone
    # --- TPU-native additions ---
    conv_channels: int = 64
    conv_out_channels: int = 8
    num_extra_dilated_blocks: int = 0  # deeper stack for the wide variant
    causal: bool = False  # causal (left-only-context) conv stack for
    # zero-lookahead streaming; train with it on for streaming deployment
    dropout: float = 0.0  # train-time dropout on the LSTM input features
    # and the LSTM output (0 = reference behavior; no dropout params, so
    # checkpoints are unchanged either way)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class VoiceFilterAudioConfig:
    """Default audio backend (reference `config.json:83-95`).

    16 kHz, n_fft 1200 / hop 160 / win 400 -> F = 601 bins, ~301 frames for
    a 3 s clip.
    """

    n_fft: int = 1200
    num_mels: int = 40
    num_freq: int = 601  # n_fft // 2 + 1
    sample_rate: int = 16000
    hop_length: int = 160
    win_length: int = 400
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    preemphasis: float = 0.97
    power: float = 1.5
    griffin_lim_iters: int = 60

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VoiceFilterAudioConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class WaveRNNAudioConfig:
    """Alternative backend with ms-based STFT params (reference `config.json:61-82`)."""

    force_convert_SR: bool = True
    num_mels: int = 80
    num_freq: int = 1025
    sample_rate: int = 16000
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    preemphasis: float = 0.98
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    signal_norm: bool = True
    symmetric_norm: bool = False
    max_norm: float = 1.0
    clip_norm: bool = True
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    do_trim_silence: bool = True
    power: float = 1.5
    griffin_lim_iters: int = 60

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000.0 * self.sample_rate)

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000.0 * self.sample_rate)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WaveRNNAudioConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class WaveGlowAudioConfig:
    """Alternative backend over conv1d-STFT semantics (reference `config.json:47-60`)."""

    segment_length: int = 16000
    sample_rate: int = 22050
    filter_length: int = 1024
    num_freq: int = 513  # filter_length // 2 + 1
    n_mel_channels: int = 80
    hop_length: int = 256
    win_length: int = 1024
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    power: float = 1.5
    griffin_lim_iters: int = 60

    @property
    def n_fft(self) -> int:
        return self.filter_length

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WaveGlowAudioConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class AudioConfig:
    backend: str = "voicefilter"  # voicefilter | wavernn | waveglow
    mel_spec: bool = False
    audio_len: float = 3.0  # fixed crop length in seconds (static shapes!)
    voicefilter: VoiceFilterAudioConfig = field(default_factory=VoiceFilterAudioConfig)
    wavernn: WaveRNNAudioConfig = field(default_factory=WaveRNNAudioConfig)
    waveglow: WaveGlowAudioConfig = field(default_factory=WaveGlowAudioConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AudioConfig":
        d = dict(_filter_kwargs(cls, d))
        if isinstance(d.get("voicefilter"), dict):
            d["voicefilter"] = VoiceFilterAudioConfig.from_dict(d["voicefilter"])
        if isinstance(d.get("wavernn"), dict):
            d["wavernn"] = WaveRNNAudioConfig.from_dict(d["wavernn"])
        if isinstance(d.get("waveglow"), dict):
            d["waveglow"] = WaveGlowAudioConfig.from_dict(d["waveglow"])
        return cls(**d)

    @property
    def active(self):
        """The config object of the selected backend."""
        return getattr(self, self.backend)


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------


@dataclass
class Config:
    model_name: str = "voicesplit"  # "voicefilter" (relu) | "voicesplit" (mish)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    test_config: TestConfig = field(default_factory=TestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(_filter_kwargs(cls, d))
        for key, sub in (
            ("dataset", DatasetConfig),
            ("loss", LossConfig),
            ("train_config", TrainConfig),
            ("test_config", TestConfig),
            ("model", ModelConfig),
            ("audio", AudioConfig),
        ):
            if isinstance(d.get(key), dict):
                d[key] = sub.from_dict(d[key])
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """Canonical JSON string — embedded into checkpoints."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def load_config(path: str) -> Config:
    """Load a config from a JSON file, tolerating ``//`` comments.

    Accepts both this framework's configs and the reference's
    `config.json` schema unchanged.
    """
    with open(path, "r") as f:
        text = f.read()
    return load_config_from_str(text)


def load_config_from_str(text: str) -> Config:
    """Parse a config from a JSON string (e.g. recovered from a checkpoint)."""
    data = json.loads(_strip_json_comments(text))
    return Config.from_dict(data)
