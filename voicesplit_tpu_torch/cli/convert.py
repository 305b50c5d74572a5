"""Batch spectrogram → wav conversion CLI (PyTorch counterpart of
`voicesplit_tpu/cli/convert.py`; reference `convert.py:18-26`, minus the
hardcoded paths).

    python -m voicesplit_tpu_torch.cli.convert --input_dir specs/ \
        --output_dir wavs/ [-c config.json] [--device cuda|cpu]

Reads ``*.npy`` (or torch ``*.pt``) normalized spectrograms ``[T, F]`` and
writes Griffin-Lim reconstructions (`dsp/griffin_lim.py`, the config's
iteration count) as ``<name>.wav``.  Griffin-Lim runs on the CUDA card
unless ``--device cpu`` is given.  Returns the written paths.
"""

from __future__ import annotations

import argparse
import os
from glob import glob


def main(argv=None):
    parser = argparse.ArgumentParser(description="Griffin-Lim a folder of spectrograms (PyTorch)")
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from voicesplit_tpu_torch.config import Config, load_config
    from voicesplit_tpu_torch.data.dataset import _load_array
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor

    config = load_config(args.config_path) if args.config_path else Config()
    ap = make_audio_processor(config, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(glob(os.path.join(args.input_dir, "*.npy"))) + sorted(
        glob(os.path.join(args.input_dir, "*.pt"))
    )
    written = []
    for path in files:
        spec = np.asarray(_load_array(path), np.float32)
        wav = ap.spec2wav(spec, None)  # no phase: Griffin-Lim
        name = os.path.splitext(os.path.basename(path))[0] + ".wav"
        ap.save_wav(wav, os.path.join(args.output_dir, name))
        written.append(os.path.join(args.output_dir, name))
        print(f"{path} -> {name}")
    print(f"converted {len(files)} files")
    return written


if __name__ == "__main__":
    main()
