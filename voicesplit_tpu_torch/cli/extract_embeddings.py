"""Speaker-embedding extraction CLI (PyTorch counterpart of
`voicesplit_tpu/cli/extract_embeddings.py`).

    python -m voicesplit_tpu_torch.cli.extract_embeddings --data_dir DIR \
        [--encoder ge2e|corentinj|speech2phone|spectral] \
        [--encoder_checkpoint PATH] [-c config.json] [--device cpu]

Embeds every ``*-ref_emb.wav`` of a directory and writes its ``*-emb.npy``
(the reference notebook's `GE2E-...-openvoicefilter.py:129-152`, which the
port's `data/dataset.py` reads); a reference shorter than one window gets the
``[0]`` sentinel the dataset layer filters out.  Encoders:

- ``ge2e`` (default): `SpeakerEncoder` on the config's log-mels, windows of 80
  frames at stride 40 embedded in fixed batches of 32 (three `lstm_fwd`
  launches a batch) and mean-pooled.  ``--encoder_checkpoint``: the port's
  ``encoder_<step>.pt`` or the JAX CLI's ``encoder_<step>.msgpack`` (each
  carries its topology), or the reference's ``embedder.pt`` state dict;
  without one, random weights from seed 0 (pipeline smoke runs).
- ``corentinj``: the CorentinJ topology on its linear-power mels (160-frame
  partials), renormalized after the mean; ``--encoder_checkpoint`` is its
  ``pretrained.pt``.
- ``speech2phone``: the MFCC encoder's 80-d CReLU embedding;
  ``--encoder_checkpoint`` an ``.npz`` / ``.pt`` weight export.
- ``spectral``: training-free signal-derived d-vectors (no checkpoint).

The device is the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

WINDOW_BATCH = 32  # windows a batch: one shape for the encoder


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract speaker d-vectors (PyTorch)")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--encoder_checkpoint", type=str, default=None,
                        help="encoder_<step>.pt / .msgpack or the reference's embedder.pt "
                             "(ge2e), pretrained.pt (corentinj), an .npz/.pt export "
                             "(speech2phone)")
    parser.add_argument("--encoder", type=str, default="ge2e",
                        choices=("ge2e", "spectral", "corentinj", "speech2phone"))
    parser.add_argument("--glob_wav", type=str, default="*-ref_emb.wav")
    parser.add_argument("--out_suffix", type=str, default="-emb.npy")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from voicesplit_tpu_torch.config import Config, load_config
    from voicesplit_tpu_torch.device import resolve_device
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor

    config = load_config(args.config_path) if args.config_path else Config()
    dev = resolve_device(args.device)
    ap = make_audio_processor(config, device=dev)
    files = sorted(glob(os.path.join(args.data_dir, args.glob_wav)))
    stem = args.glob_wav.replace("*", "")

    def out_path(path: str) -> str:
        return path.replace(stem, "") + args.out_suffix

    if args.encoder == "spectral":
        from voicesplit_tpu_torch.models.speaker_encoder import spectral_dvector

        for path in files:
            emb = spectral_dvector(ap.load_wav(path), ap.sample_rate, emb_dim=config.model.emb_dim)
            np.save(out_path(path), emb)
        print(f"wrote {len(files)} spectral embeddings in {args.data_dir}")
        return

    if args.encoder == "speech2phone":
        from voicesplit_tpu_torch.models.speech2phone import (
            Speech2PhoneEncoder,
            load_speech2phone_weights,
            speech2phone_embedding,
        )
        from voicesplit_tpu_torch.weights import lecun_normal_

        encoder = Speech2PhoneEncoder()
        if args.encoder_checkpoint:
            encoder.load_state_dict(load_speech2phone_weights(args.encoder_checkpoint))
        else:
            print(" > No encoder checkpoint given — using random init (smoke mode)")
            with torch.no_grad():
                lecun_normal_(encoder.fc.weight, encoder.fc.in_features, torch.Generator().manual_seed(0))
                encoder.fc.bias.zero_()
        encoder = encoder.to(dev)
        n_ok = n_short = 0
        for path in files:
            emb = speech2phone_embedding(encoder, ap.load_wav(path), ap.sample_rate)
            n_short += emb.size == 1
            n_ok += emb.size != 1
            np.save(out_path(path), emb)
        print(f"wrote {n_ok} speech2phone embeddings ({n_short} sentinels) in {args.data_dir}")
        return

    from voicesplit_tpu_torch.train.encoder import embed_windows, load_ge2e_encoder, utterance_windows

    if args.encoder == "corentinj":
        from voicesplit_tpu_torch.models.speaker_encoder import (
            corentinj_mel,
            load_corentinj_state_dict,
            make_corentinj_encoder,
        )
        from voicesplit_tpu_torch.weights import init_encoder_for_training_

        encoder = make_corentinj_encoder(device="cpu")
        if args.encoder_checkpoint:
            payload = torch.load(args.encoder_checkpoint, map_location="cpu", weights_only=False)
            encoder.load_state_dict(load_corentinj_state_dict(payload.get("model_state", payload)))
        else:
            print(" > No encoder checkpoint given — using random init (smoke mode)")
            init_encoder_for_training_(encoder, 0)
        encoder = encoder.to(dev)
    else:
        encoder = load_ge2e_encoder(args.encoder_checkpoint, config.audio.active.num_mels, dev)
    encoder.eval()

    W, S = encoder.window, encoder.stride
    n_ok = n_short = 0
    for path in files:
        wav = ap.load_wav(path)
        if args.encoder == "corentinj":
            mel = corentinj_mel(wav, ap.sample_rate)  # linear-power mels, 25 ms / 10 ms
        else:
            mel = np.asarray(ap.get_mel_bucketed(wav), np.float32)  # [n_mels, T]
        if mel.shape[1] < W:
            # sentinel for too-short references (reference `:147-152`)
            np.save(out_path(path), np.array([0], np.float32))
            n_short += 1
            continue
        emb = embed_windows(encoder, utterance_windows(mel, W, S), WINDOW_BATCH).mean(axis=0)
        if encoder.final_renorm:  # CorentinJ renorms the pooled embedding
            emb = emb / (np.linalg.norm(emb) + 1e-8)
        np.save(out_path(path), emb.astype(np.float32))
        n_ok += 1
    print(f"wrote {n_ok} embeddings ({n_short} sentinels) in {args.data_dir}")


if __name__ == "__main__":
    main()
