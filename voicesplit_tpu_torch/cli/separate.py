"""Inference CLI: separate a target voice out of a mixture wav (PyTorch
counterpart of `voicesplit_tpu/cli/separate.py`, whose command line it takes
unchanged, plus ``--device``).

    python -m voicesplit_tpu_torch.cli.separate --checkpoint_path best.msgpack \
        --mixed_wav mix.wav (--emb emb.npy | --reference_wav ref.wav \
        --encoder_checkpoint embedder.pt) --output out.wav \
        [-c config.json] [--streaming [--chunk_frames N]] [--sequence_parallel] \
        [--griffin_lim] [--device cuda|cpu]

``--checkpoint_path`` is the JAX package's ``checkpoint_<step>.msgpack`` or
the port's ``checkpoint_<step>.pt`` (of its trainer, `cli.import_torch` or
`cli.convert_streaming`), told apart by the suffix; the config is the one
embedded in the checkpoint unless ``-c`` names one.  ``--weights`` instead
takes a file written by `voicesplit_tpu_torch.weights.save` (which needs
``-c``) or a ``checkpoint_<step>.pt``; one of the two is required.  Every
checkpoint is held to the model's names and shapes before it is loaded, so a
BiLSTM checkpoint given with ``--streaming`` raises ``ValueError``.
``--emb`` is a d-vector as ``.npy`` or ``.pt`` (the reference's
``*-emb.pt``).

Spectrogram of the mixture → mask network → ``mask * spec`` → iSTFT with
the mixture phase (reference eval behavior, `utils/generic_utils.py:504`);
``--griffin_lim`` re-estimates the phase instead (`dsp/griffin_lim.py`).
``--sequence_parallel`` runs the long-form engine (`parallel/sequence.py`):
the utterance's time axis sharded over the ranks of a started process group,
a world of one (the whole utterance on the card) without one.
``--streaming`` runs the chunked low-latency engine (`streaming.py`) over the
streaming model (forward-only LSTM; causal convs where the config says so),
whose weights come from a streaming checkpoint, e.g. one written by either
package's `cli.convert_streaming`.
``--reference_wav`` takes the d-vector from a clip of the target speaker
instead of ``--emb``: the GE2E encoder of ``--encoder_checkpoint`` (the
reference's ``embedder.pt``, or the port's / JAX CLI's encoder checkpoint) on
the clip's log-mel, windows of 80 frames at stride 40 in batches of 32, their
plain mean (`train/encoder.py::embed_reference`), as the JAX CLI takes it.
The device is the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from voicesplit_tpu_torch.dsp.processor import AudioProcessor
from voicesplit_tpu_torch.models.masknet import MaskNet
from voicesplit_tpu_torch.utils.profiling import span

def separate_batch(
    model: MaskNet, ap: AudioProcessor, mixed, emb
) -> torch.Tensor:
    """Mixtures ``[B, L]`` and d-vectors ``[B, emb]`` → separated ``[B, L]``
    (float32, on the model's device)."""
    with span("voicesplit.separate_batch"):
        dev = next(model.parameters()).device
        mixed = torch.as_tensor(mixed, dtype=torch.float32, device=dev)
        emb = torch.as_tensor(emb, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            spec, phase = ap.wav2spec_batch(mixed)
            mask = model(spec, emb)
            return ap.spec2wav_batch(mask * spec, phase, length=mixed.shape[-1])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Targeted voice separation (PyTorch)")
    weights_from = parser.add_mutually_exclusive_group(required=True)
    weights_from.add_argument("--checkpoint_path", type=str,
                              help="a JAX checkpoint_<step>.msgpack or a port checkpoint_<step>.pt")
    weights_from.add_argument("--weights", type=str,
                              help="the port's .pt weights (with -c), or a checkpoint_<step>.pt")
    parser.add_argument("-c", "--config_path", type=str, default=None,
                        help="default: the config embedded in the checkpoint")
    parser.add_argument("--mixed_wav", type=str, required=True)
    parser.add_argument("--emb", type=str, default=None, help="*.npy / *.pt d-vector")
    parser.add_argument("--reference_wav", type=str, default=None,
                        help="take the d-vector from this clip of the target speaker instead")
    parser.add_argument("--encoder_checkpoint", type=str, default=None,
                        help="with --reference_wav: the GE2E encoder's checkpoint")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--streaming", action="store_true")
    parser.add_argument("--chunk_frames", type=int, default=50)
    parser.add_argument("--griffin_lim", action="store_true")
    parser.add_argument("--sequence_parallel", action="store_true",
                        help="shard the time axis over the process group's ranks "
                             "(long-form inference, parallel/sequence.py)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.train.checkpoint import is_checkpoint_name

    checkpoint = args.checkpoint_path or (args.weights if is_checkpoint_name(args.weights) else None)
    if checkpoint is None and not args.config_path:
        parser.error("--weights with a weights file (not a checkpoint_<step>.pt) "
                     "needs -c/--config_path")
    if not args.emb and not args.reference_wav:
        raise SystemExit("provide --emb or --reference_wav")
    if not args.emb and not args.encoder_checkpoint:
        raise SystemExit("--reference_wav requires --encoder_checkpoint")

    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.test import load_weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.dataset import _load_array
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet

    if checkpoint is None:
        config = load_config(args.config_path)
        model = weights.load(make_masknet(config, streaming=args.streaming, device=args.device),
                             args.weights)
    else:
        config, sd = load_weights(checkpoint, args.config_path, args.streaming)
        model = make_masknet(config, streaming=args.streaming, device=args.device)
        model.load_state_dict(sd)
    ap = make_audio_processor(config, device=args.device)
    if args.emb:
        emb = np.asarray(_load_array(args.emb), np.float32).reshape(1, -1)
    else:
        from voicesplit_tpu_torch.train.encoder import embed_reference, load_ge2e_encoder

        p = config.audio.active
        # waveglow's config field is n_mel_channels (reference schema)
        num_mels = getattr(p, "num_mels", getattr(p, "n_mel_channels", 40))
        encoder = load_ge2e_encoder(args.encoder_checkpoint, num_mels, ap.device).eval()
        emb = embed_reference(encoder, ap, ap.load_wav(args.reference_wav))[None]
    mixed = ap.load_wav(args.mixed_wav)
    if args.streaming:
        from voicesplit_tpu_torch.streaming import StreamingSeparator

        sep = StreamingSeparator(config, model, args.chunk_frames, device=args.device)
        out = sep.separate(mixed[None], emb)[0]
    elif args.sequence_parallel:
        from voicesplit_tpu_torch.parallel.sequence import separate_long

        out = separate_long(config, model, mixed, emb[0])
    elif args.griffin_lim:
        spec, _ = ap.wav2spec(mixed)
        with torch.inference_mode():
            net_in = torch.as_tensor(spec[None], device=ap.device)
            mask = model(net_in, torch.as_tensor(emb, device=ap.device))[0].cpu().numpy()
        out = ap.spec2wav(mask * spec, None)
    else:
        out = separate_batch(model, ap, mixed[None], emb)[0].cpu().numpy()
    ap.save_wav(out, args.output)
    print(f"wrote {args.output} ({len(out) / ap.sample_rate:.2f}s)")


if __name__ == "__main__":
    main()
