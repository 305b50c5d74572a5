"""Ahead-of-time export: saved, servable separation programs (counterpart of
`voicesplit_tpu/export.py`).

The JAX package serializes StableHLO with `jax.export`; the port traces the
same computations with `torch.export` and saves each as a ``.pt2`` program
(`torch.export.save`) with the weights inside it:

- `export_separator`: wav ``[B, L]`` + d-vector ``[B, E]`` → separated wav
  ``[B, L]`` (STFT → eval-mode mask network → masked iSTFT with the
  mixture's phase), L fixed by `seconds`, the batch free (symbolic) or
  pinned.  A free batch traces the BiLSTM's route that serves any batch,
  its two `lstm_fwd` calls (the ``B % 8`` dispatch cannot be decided on a
  symbolic batch), as the JAX package exports its ``lax.scan``; a pinned
  batch keeps the model's dispatch (``bilstm_fwd`` at a multiple of 8).
- `export_streaming`: the streaming chunk step with `StreamState`'s six
  fields flattened to a tuple, ``(*state, samples, emb) -> (*state, out)``,
  and a manifest with the JAX package's keys.
- `load_exported` / `load_artifact`: the saved program as a callable.

Kernels.  The program calls the forward kernels as the `torch.library`
operators ``voicesplit::lstm_fwd``, ``voicesplit::bilstm_fwd`` and
``voicesplit::conv_dilated_fwd`` (with ``VOICESPLIT_PALLAS_CONV=1`` at
export); the operator picks the kernel for CUDA tensors and the plain
version for CPU ones when the program runs.

Loading.  Unlike a StableHLO artifact, a ``.pt2`` program needs the port's
operators registered before it loads: ``import voicesplit_tpu_torch.ops``
(this module's loaders do it), which also builds the kernels' library at
the first launch on the card (nvcc, `ops/_build.py`).  It needs no model
code: no `models/`, `dsp/` or `streaming.py` module is imported to load or
run it.

Devices.  A program runs on the device it was exported on.  ``platforms``
names the devices (``"cuda"``, ``"cpu"``); each gets its own program, and
`save_artifact` writes one file each and lists them in the manifest.  The
default is the card (an error without one), never a silent CPU.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

import voicesplit_tpu_torch.ops  # noqa: F401  (registers the kernels' operators)
from voicesplit_tpu_torch.device import resolve_device, set_fp32_precision

PLATFORMS = ("cuda", "cpu")
LOAD_NEEDS = "import voicesplit_tpu_torch.ops"
# the example batch a symbolic-batch export traces with: 2, so that the batch
# is not specialized to 1
_EXAMPLE_BATCH = 2


def _devices(platforms: Optional[Sequence[str]]) -> Tuple[str, ...]:
    if not platforms:
        return (resolve_device(None).type,)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}; choose from {PLATFORMS}")
    for p in platforms:
        resolve_device(p)  # raises for "cuda" without a card
    return tuple(dict.fromkeys(platforms))


def _model(config, variables: Mapping[str, torch.Tensor], device, streaming: bool = False):
    from voicesplit_tpu_torch.models.masknet import make_masknet

    model = make_masknet(config, streaming=streaming, device=device)
    model.load_state_dict(variables)
    return model


class E2ESeparator(torch.nn.Module):
    """``forward(mixed_wav [B, L], emb [B, E]) -> separated [B, L]``: the
    eval-mode pipeline as one module (mixture-phase inversion)."""

    def __init__(self, model, ap):
        super().__init__()
        self.model = model
        self.ap = ap

    def forward(self, mixed_wav: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        spec, phase = self.ap.wav2spec_batch(mixed_wav)
        mask = self.model(spec, emb)
        return self.ap.spec2wav_batch(mask * spec, phase, length=mixed_wav.shape[-1])


def make_e2e_separation_fn(config, variables: Mapping[str, torch.Tensor],
                           synthesis_window: str = "hann", device=None) -> E2ESeparator:
    """The whole separation as one module with the weights of `variables`
    (the model's ``state_dict``), on `device` (the card by default).  A
    fresh `AudioProcessor`; its DSP bases are ordinary cached tensors, which
    `torch.export` takes in as constants."""
    from voicesplit_tpu_torch.dsp.processor import AudioProcessor

    dev = resolve_device(device)
    return E2ESeparator(_model(config, variables, dev),
                        AudioProcessor(config.audio, synthesis_window, dev)).eval()


def _save(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_separator(
    config,
    variables: Mapping[str, torch.Tensor],
    seconds: float = 3.0,
    platforms: Optional[Sequence[str]] = None,
    symbolic_batch: bool = True,
    batch_size: int = 1,
) -> Dict[str, bytes]:
    """The saved e2e separation program for each device of `platforms`:
    ``{device: .pt2 bytes}``.  ``symbolic_batch`` leaves B free at serve
    time (traced at B=2); otherwise it is pinned to `batch_size`."""
    out = {}
    for dev in _devices(platforms):
        sep = make_e2e_separation_fn(config, variables, device=dev)
        L = int(sep.ap.sample_rate * seconds)
        B = _EXAMPLE_BATCH if symbolic_batch else batch_size
        args = (torch.zeros(B, L, device=dev), torch.zeros(B, config.model.emb_dim, device=dev))
        dynamic = None
        if symbolic_batch:
            b = torch.export.Dim("batch", min=1)
            dynamic = {"mixed_wav": {0: b}, "emb": {0: b}}
        with torch.no_grad():  # export cannot trace under inference mode
            # one eager call first: the DSP bases and envelopes are cached
            # tensors (`dsp/stft.py`), and made while tracing they would be
            # the tracer's fake tensors, handed to every later eager call
            sep(*args)
            out[dev] = _save(torch.export.export(sep, args, dynamic_shapes=dynamic))
    return out


def separator_manifest(seconds: float, sample_rate: int, emb_dim: int,
                       fixed_batch: Optional[int], platforms: Sequence[str]) -> dict:
    """The e2e program's manifest: the JAX CLI's keys and the port's."""
    return {
        "kind": "e2e_separator",
        "seconds": seconds,
        "batch": fixed_batch or "symbolic",
        "platforms": list(platforms),
        "samples": int(sample_rate * seconds),
        "emb_dim": emb_dim,
        "calling_convention": "(mixed_wav [B, L], emb [B, E]) -> separated [B, L]",
        "load_needs": LOAD_NEEDS,
    }


class _ChunkStep(torch.nn.Module):
    """`StreamingSeparator._chunk_step` on a flat argument tuple."""

    def __init__(self, sep):
        super().__init__()
        self.model = sep.model
        self.sep = sep

    def forward(self, sample_tail, spec_hist, phase_hist, lstm_h, lstm_c, ola_tail, samples, emb):
        from voicesplit_tpu_torch.streaming import StreamState

        state = StreamState(sample_tail, spec_hist, phase_hist, lstm_h, lstm_c, ola_tail)
        new, out = self.sep._chunk_step(state, samples, emb)
        return (new.sample_tail, new.spec_hist, new.phase_hist, new.lstm_h, new.lstm_c,
                new.ola_tail, out)


def state_fields(state) -> Tuple[torch.Tensor, ...]:
    """A `StreamState`'s six tensors in the order the chunk step takes them."""
    return (state.sample_tail, state.spec_hist, state.phase_hist, state.lstm_h, state.lstm_c,
            state.ola_tail)


def export_streaming(
    config,
    variables: Mapping[str, torch.Tensor],
    chunk_frames: int = 50,
    batch_size: int = 1,
    platforms: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, bytes], dict]:
    """The saved streaming chunk step for each device of `platforms` and its
    manifest: the state layout, chunk size and latency, so that a server
    allocates zero state and threads it,
    ``(*state, out) = step(*state, samples, emb)``."""
    from voicesplit_tpu_torch.streaming import StreamingSeparator

    out, manifest = {}, None
    for dev in _devices(platforms):
        sep = StreamingSeparator(config, _model(config, variables, dev, streaming=True),
                                 chunk_frames=chunk_frames, device=dev)
        state = state_fields(sep.init_state(batch_size))
        args = (*state, torch.zeros(batch_size, sep.chunk_samples, device=dev),
                torch.zeros(batch_size, config.model.emb_dim, device=dev))
        with torch.no_grad():
            out[dev] = _save(torch.export.export(_ChunkStep(sep), args))
        manifest = {
            "kind": "streaming_chunk_step",
            "batch_size": batch_size,
            "chunk_frames": chunk_frames,
            "chunk_samples": sep.chunk_samples,
            "latency_samples": sep.latency_samples,
            "sample_rate": sep.ap.sample_rate,
            "state_fields": [{"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", "")}
                             for x in state],
            "calling_convention": "(*state, samples, emb) -> (*state, out)",
            "platforms": list(out),
            "load_needs": LOAD_NEEDS,
        }
    return out, manifest


def load_exported(data: bytes):
    """A saved program (``.pt2`` bytes) as a callable module, under the
    port's float32 policy (no TF32, as every entry point sets it)."""
    set_fp32_precision()
    return torch.export.load(io.BytesIO(bytes(data))).module()


def _device_path(path: str, device: str, n: int) -> str:
    if n == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{device}{ext}"


def save_artifact(path: str, data: Union[bytes, Mapping[str, bytes]],
                  manifest: Optional[dict] = None) -> Dict[str, str]:
    """Writes each device's program (`path` itself for one device, else
    ``<stem>.<device><ext>`` beside it) and, with a manifest, ``path +
    ".json"`` listing them under ``"artifacts"``; returns ``{device:
    file}``."""
    programs = dict(data) if isinstance(data, Mapping) else {"default": bytes(data)}
    files = {}
    for dev, blob in programs.items():
        files[dev] = _device_path(path, dev, len(programs))
        with open(files[dev], "wb") as f:
            f.write(blob)
    if manifest is not None:
        manifest = {**manifest, "artifacts": {d: os.path.basename(p) for d, p in files.items()}}
        with open(path + ".json", "w") as f:
            json.dump(manifest, f, indent=2)
    return files


def load_artifact(path: str, device: Optional[str] = None):
    """The program saved at `path`; where the manifest beside it lists one
    program a device, the one for `device` (the card by default)."""
    try:
        with open(path + ".json") as f:
            artifacts = json.load(f).get("artifacts", {})
    except FileNotFoundError:
        artifacts = {}
    if len(artifacts) > 1:
        dev = device or resolve_device(None).type
        if dev not in artifacts:
            raise ValueError(f"no program for {dev!r} in {path}.json (has {sorted(artifacts)})")
        path = os.path.join(os.path.dirname(path), artifacts[dev])
    with open(path, "rb") as f:
        return load_exported(f.read())
