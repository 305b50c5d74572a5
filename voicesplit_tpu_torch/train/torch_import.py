"""Import the reference's torch checkpoints (``checkpoint_%d.pt``) into the
port, and export the port's weights in the reference's layout (counterpart of
`voicesplit_tpu/train/torch_import.py`).

The reference saves ``{'model': state_dict, 'optimizer': state_dict, 'step':
int, 'config_str': str(AttrDict)}`` (reference `train.py:126-132`) for the
`VoiceFilter` / `VoiceSplit` topology (`models/voicefilter/model.py:11-90`):

- ``conv.{i}.weight/bias``: 8 Conv2d layers inside one ``nn.Sequential``
  interleaved with ZeroPad2d / BatchNorm2d / activation modules; the Conv2d
  modules sit at sequence indices (1, 5, 9, 13, 17, 21, 25, 28) and the
  BatchNorm2d modules at (2, 6, 10, 14, 18, 22, 26, 29);
- ``lstm.weight_ih_l0[_reverse]`` ``[4H, in]``, ``weight_hh_l0[_reverse]``
  ``[4H, H]``, ``bias_ih_l0[_reverse]`` + ``bias_hh_l0[_reverse]``: a
  bidirectional ``nn.LSTM`` with torch's ``[i, f, g, o]`` gates, the port's
  gate order (the port keeps one summed bias);
- ``fc1.weight [600, 800]``, ``fc2.weight [601, 600]`` + biases.

The port's `MaskNet` keeps torch's layouts for convs (``[out, in, kt, kf]``)
and dense layers (``[out, in]``), so those copy over as they are; its LSTM
takes ``[in, 4H]`` / ``[H, 4H]`` (transposed).  One representation change
remains: the reference flattens the conv features channel-major (index
``c*F + f``, `model.py:73-75`), the port frequency-major (``f*C + c``,
`MaskNet.conv_features`), so the rows of the BiLSTM's input projection for
the first ``C*F`` inputs are permuted (`flatten_permutation`) and the
imported model computes the reference's function.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from voicesplit_tpu_torch.config import Config, load_config_from_str

# nn.Sequential indices of the Conv2d / BatchNorm2d modules in the reference
# conv stack (`models/voicefilter/model.py:17-54`)
TORCH_CONV_IDX = (1, 5, 9, 13, 17, 21, 25, 28)
TORCH_BN_IDX = (2, 6, 10, 14, 18, 22, 26, 29)


def _f32(x) -> torch.Tensor:
    """A tensor or array as a float32 CPU tensor of its own."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flatten_permutation(num_freq: int, channels: int) -> np.ndarray:
    """``perm[j]`` = the reference's flat index feeding the port's flat
    feature j: the port flattens ``j = f*C + c``, the reference ``c*F + f``;
    ``port_w_ih[j] = ref_w_ih[perm[j]]``."""
    f = np.arange(num_freq * channels) // channels
    c = np.arange(num_freq * channels) % channels
    return c * num_freq + f


def convert_torch_state_dict(
    sd: Mapping[str, Any], num_freq: int = 601, conv_out_channels: int = 8
) -> Dict[str, torch.Tensor]:
    """The reference's ``state_dict`` (a ``module.`` prefix is dropped) → the
    port's `MaskNet` state dict (parameters and running statistics, fp32)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for i, (ci, bi) in enumerate(zip(TORCH_CONV_IDX, TORCH_BN_IDX)):
        name = f"conv{i + 1}"
        out[f"{name}.conv.weight"] = _f32(sd[f"conv.{ci}.weight"])
        out[f"{name}.conv.bias"] = _f32(sd[f"conv.{ci}.bias"])
        out[f"{name}.bn.scale"] = _f32(sd[f"conv.{bi}.weight"])
        out[f"{name}.bn.bias"] = _f32(sd[f"conv.{bi}.bias"])
        out[f"{name}.bn.mean"] = _f32(sd[f"conv.{bi}.running_mean"])
        out[f"{name}.bn.var"] = _f32(sd[f"conv.{bi}.running_var"])
    perm = torch.from_numpy(flatten_permutation(num_freq, conv_out_channels))
    n_feat = num_freq * conv_out_channels
    for suffix, d in (("", "fwd"), ("_reverse", "bwd")):
        w_ih = _f32(sd[f"lstm.weight_ih_l0{suffix}"]).t()  # [in, 4H]
        # the conv-feature rows into the port's f*C + c order; the trailing
        # emb_dim rows (the d-vector) keep theirs
        out[f"lstm.{d}_w_ih"] = torch.cat([w_ih[:n_feat][perm], w_ih[n_feat:]]).contiguous()
        out[f"lstm.{d}_w_hh"] = _f32(sd[f"lstm.weight_hh_l0{suffix}"]).t().contiguous()
        out[f"lstm.{d}_b"] = _f32(sd[f"lstm.bias_ih_l0{suffix}"]) + _f32(sd[f"lstm.bias_hh_l0{suffix}"])
    for fc in ("fc1", "fc2"):
        out[f"{fc}.weight"] = _f32(sd[f"{fc}.weight"])
        out[f"{fc}.bias"] = _f32(sd[f"{fc}.bias"])
    return out


def export_torch_state_dict(
    sd: Mapping[str, torch.Tensor], num_freq: int = 601, conv_out_channels: int = 8
) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_torch_state_dict`: the port's `MaskNet` state dict
    → a reference-keyed state dict (``bias_hh`` zero, the summed bias in
    ``bias_ih``), so models trained here can be served by the reference."""
    out: Dict[str, torch.Tensor] = {}
    for i, (ci, bi) in enumerate(zip(TORCH_CONV_IDX, TORCH_BN_IDX)):
        name = f"conv{i + 1}"
        out[f"conv.{ci}.weight"] = _f32(sd[f"{name}.conv.weight"])
        out[f"conv.{ci}.bias"] = _f32(sd[f"{name}.conv.bias"])
        out[f"conv.{bi}.weight"] = _f32(sd[f"{name}.bn.scale"])
        out[f"conv.{bi}.bias"] = _f32(sd[f"{name}.bn.bias"])
        out[f"conv.{bi}.running_mean"] = _f32(sd[f"{name}.bn.mean"])
        out[f"conv.{bi}.running_var"] = _f32(sd[f"{name}.bn.var"])
        out[f"conv.{bi}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    inv = torch.from_numpy(np.argsort(flatten_permutation(num_freq, conv_out_channels)))
    n_feat = num_freq * conv_out_channels
    for suffix, d in (("", "fwd"), ("_reverse", "bwd")):
        w_ih = _f32(sd[f"lstm.{d}_w_ih"])
        out[f"lstm.weight_ih_l0{suffix}"] = torch.cat([w_ih[:n_feat][inv], w_ih[n_feat:]]).t().contiguous()
        out[f"lstm.weight_hh_l0{suffix}"] = _f32(sd[f"lstm.{d}_w_hh"]).t().contiguous()
        b = _f32(sd[f"lstm.{d}_b"])
        out[f"lstm.bias_ih_l0{suffix}"] = b
        out[f"lstm.bias_hh_l0{suffix}"] = torch.zeros_like(b)
    for fc in ("fc1", "fc2"):
        out[f"{fc}.weight"] = _f32(sd[f"{fc}.weight"])
        out[f"{fc}.bias"] = _f32(sd[f"{fc}.bias"])
    return out


def parse_reference_config_str(text: str) -> Config:
    """A checkpoint's embedded config string: the port's and the JAX
    package's are canonical JSON; the reference's is ``str(AttrDict)``, a
    Python dict repr (it reparses with yaml, `generic_utils.py:575-581`).
    Unknown top-level keys (the reference's `copy_config_file` can add some)
    are dropped with a notice rather than rejected."""
    try:
        return load_config_from_str(text)
    except (json.JSONDecodeError, ValueError):
        pass
    data = ast.literal_eval(text)
    if not isinstance(data, dict):
        raise ValueError(f"config_str is not a mapping: {type(data)}")
    known = {f.name for f in dataclasses.fields(Config)}
    dropped = sorted(set(data) - known)
    if dropped:
        print(f" > import: dropping unknown config keys {dropped}")
    return Config.from_dict({k: v for k, v in data.items() if k in known})


def import_torch_checkpoint(pt_path: str, out_dir: str, config: Optional[Config] = None) -> str:
    """The reference's ``checkpoint_%d.pt`` → the port's
    ``<out_dir>/checkpoint_<step>.pt`` (`train/checkpoint.py`'s layout),
    which `cli.separate`, `cli.test` and ``Trainer(checkpoint_path=...)``
    load like a native checkpoint.  The optimizer state is not translated:
    a fresh Adam state is written, as the JAX package does.  The config is
    the payload's ``config_str`` unless `config` is given.  Returns the
    written path."""
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.checkpoint import save_checkpoint
    from voicesplit_tpu_torch.train.state import create_train_state, make_optimizer

    payload = torch.load(pt_path, map_location="cpu", weights_only=False)
    if config is None:
        if "config_str" not in payload:
            raise ValueError(f"{pt_path!r} has no embedded config_str; pass --config")
        config = parse_reference_config_str(str(payload["config_str"]))
    sd = convert_torch_state_dict(
        payload["model"], num_freq=config.audio.active.num_freq,
        conv_out_channels=config.model.conv_out_channels,
    )
    model = make_masknet(config, device="cpu")
    model.load_state_dict(sd)
    state = create_train_state(model, make_optimizer(config, model))
    state.step = int(payload.get("step", 0))
    os.makedirs(out_dir, exist_ok=True)
    return save_checkpoint(out_dir, state, config)
