"""The spectrogram-mask network (PyTorch counterpart of
`voicesplit_tpu/models/masknet.py`).

    spec [B, T, F] → [B, 1, T, F] (NCHW: time is H, frequency is W)
      conv1 1×7, conv2 7×1, then 5×5 with time dilation 1/2/4/8/16
      (and 32·2^i for each of ``num_extra_dilated_blocks``, the wide
      variant), ``conv_channels`` channels (64 in the configs), BatchNorm +
      activation each, symmetric "same" zero padding
    1×1 conv → 8 channels → [B, T, 8F], frequency-major (index f·C + c)
    concat the d-vector per frame → [B, T, 8F + emb]
    BiLSTM(→ 2×400) → ReLU → fc1(600) → ReLU → fc2(601) → sigmoid (fp32)

`activation="relu"` is VoiceFilter, `"mish"` VoiceSplit.  Parameters are
float32 and cast to ``compute_dtype`` where they are used, as in JAX.  The
JAX model flattens ``[B, T, F, 8]`` frequency-major (`masknet.py:495-506`);
this port permutes its NCHW conv output to ``[B, T, F, 8]`` before the
flatten, so the LSTM's ``w_ih`` rows line up with a JAX checkpoint's.

``model.train()`` selects train mode, as ``train=True`` does in JAX: each
BatchNorm normalizes with the batch's statistics (`ops.bn_act.bn_act_train`)
and moves its running statistics as flax does,
``r ← 0.9·r + 0.1·batch`` with the biased variance and no gradient
(``torch.nn.functional.batch_norm`` would use the unbiased variance).
``model.eval()`` uses the running statistics.

With ``VOICESPLIT_FUSED_CHAIN=1`` a train-mode forward runs ``conv2`` …
``conv7`` as one fused chain (`ops/conv_fused.py`, the JAX package's switch
and conditions): their convs, the BatchNorm + activation between them and
their batch statistics go through the chain's kernels in channels-last
``[B, T, F, C]``; ``conv1``, ``conv7``'s own BatchNorm + activation and
the 1×1 projection ``conv8`` run as usual (with extra dilated blocks the
chain runs to the last of them, whose own BatchNorm + activation runs as
usual, as in JAX).  Eval mode never takes the chain.

With ``VOICESPLIT_PALLAS_CONV=1`` (`ops/conv_cuda.py`, the JAX package's
switch) the layers that meet `conv_cuda.takes_layer` (``conv2`` … ``conv7``
and the extra dilated blocks, at any ``conv_channels`` of 64 or more)
compute their conv, and in training its two gradients, with the dilated-conv
kernels; in train mode BatchNorm + activation stay `ops/bn_act.py`, in eval
mode the block is one `conv_cuda.conv_bn_act_eval` launch (conv, bias,
BatchNorm with the running statistics and activation in the kernel's
epilogue).  ``conv1`` and the 1×1 projection take the library conv.  The JAX
model cannot run both switches at once (the chain drives the folded blocks,
which the Pallas switch turns off), so a train-mode forward with both set
raises.

Dropout (``dropout`` > 0) acts only in train mode, at the JAX model's two
sites (`masknet.py:519, :526`): on the concatenated ``[B, T, 8F + emb]``
input of the BiLSTM and on ``relu(lstm(x))`` before ``fc1``.  It is flax's
arithmetic, ``where(keep, x / keep_prob, 0)`` in the compute dtype (the
keep probability rounded to that dtype first, as JAX's weak-typed scalar
is), with the keep mask drawn from the generator the train-mode forward is
given (`forward(..., dropout_generator=g)`); without one it raises, as
flax does without a ``dropout`` rng.  `draw_dropout_keep` draws the masks,
one call per site in that order.

With ``VOICESPLIT_REMAT_CONV=1`` (`remat_convs_enabled`, the JAX package's
switch, which wraps every ``ConvBlock`` in ``nn.remat``) a train-mode
forward recomputes each conv block in the backward instead of keeping what
its backward needs: a block's conv, BatchNorm and activation run under
``torch.utils.checkpoint`` on every route (the library and causal convs, the
dilated kernel, whose forward the recompute launches again, and the fused
chain's ``conv1`` and projection, the blocks the chain calls as blocks).  A
block then keeps only its input; without the switch it also keeps its raw
conv output for the BatchNorm backward.  The checkpointed function returns
the batch statistics beside the output, and the running statistics move once,
from the forward, outside the recompute, as flax takes them from the forward
only.  Eval mode never recomputes.

``streaming=True`` swaps the BiLSTM for a `UniLSTM` whose carry ``(h, c)``
`mask_head` and ``forward`` take and return (``fc1`` then reads ``[H]``
features), the streaming engine's model (`streaming.py`).  ``causal=True``
pads every conv's time axis ``(2e, 0)`` instead of ``(e, e)`` (``e`` = half
the dilated time extent), so output frame t reads input frames up to t only
and the stack needs no lookahead (`conv_context_right` 0).  A causal layer
always runs the library conv, after an explicit `torch.nn.functional.pad`:
the JAX model sends causal layers to ``nn.Conv`` (`masknet.py:246-248`)
and turns the fused chain off (`:384-395`), and both conv kernels compute
the symmetric "same" conv, so neither switch reaches a causal model.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.models.lstm import BiLSTM, UniLSTM
from voicesplit_tpu_torch.ops.bn_act import bn_act_eval, bn_act_train, mish
from voicesplit_tpu_torch.ops.conv_cuda import (
    conv2d_bn_act_eval, conv2d_dilated_bias, pallas_conv_enabled, takes_layer,
)
from voicesplit_tpu_torch.ops.conv_fused import fused_chain_enabled, make_chain
from voicesplit_tpu_torch.utils.profiling import span

__all__ = ["BatchNorm", "ConvBlock", "MaskNet", "extra_dilated_specs", "make_masknet", "mish",
           "remat_convs_enabled"]

# flax's BatchNorm momentum (`voicesplit_tpu/models/masknet.py`):
# r ← m·r + (1 − m)·batch
_BN_MOMENTUM = 0.9

# (kernel (time, freq), dilation (time, freq)) of the seven `conv_channels`
# layers (reference `models/voicefilter/model.py:17-54`); a model with extra
# dilated blocks appends `extra_dilated_specs` to them
CONV_SPECS: List[Tuple[Tuple[int, int], Tuple[int, int]]] = [
    ((1, 7), (1, 1)),
    ((7, 1), (1, 1)),
    ((5, 5), (1, 1)),
    ((5, 5), (2, 1)),
    ((5, 5), (4, 1)),
    ((5, 5), (8, 1)),
    ((5, 5), (16, 1)),
]


def remat_convs_enabled() -> bool:
    """``VOICESPLIT_REMAT_CONV=1``: recompute each conv block in the backward
    (train mode), read at call time.  It trades one more conv, BatchNorm and
    activation forward a block for the block's raw conv output, to fit
    larger batches."""
    return os.environ.get("VOICESPLIT_REMAT_CONV", "0") == "1"


def extra_dilated_specs(n: int) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """The wide variant's extra (5, 5) blocks after ``conv7``, continuing
    the dilation doubling: time dilation 32·2^i for block i (JAX
    `masknet.py:345-346`)."""
    return [((5, 5), (32 * 2 ** i, 1)) for i in range(n)]


class BatchNorm(nn.Module):
    """BatchNorm parameters and running statistics under the JAX names
    (params ``scale``/``bias``, batch_stats ``mean``/``var``)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's momentum update with the batch's biased statistics."""
        m = _BN_MOMENTUM
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)


class ConvBlock(nn.Module):
    """"Same" Conv2D → BatchNorm → activation; with `causal` the time axis
    is padded ``(2e, 0)`` instead of ``(e, e)``."""

    def __init__(
        self,
        features: int,
        in_features: int,
        kernel: Tuple[int, int],
        dilation: Tuple[int, int] = (1, 1),
        activation: str = "relu",
        compute_dtype=torch.float32,
        causal: bool = False,
    ):
        super().__init__()
        kt, kf = kernel
        dt, df = dilation
        # the reference's explicit ZeroPad2d sizes
        self.time_pad = (kt - 1) * dt // 2
        padding = (0 if causal else self.time_pad, (kf - 1) * df // 2)
        self.conv = nn.Conv2d(in_features, features, kernel, dilation=dilation, padding=padding)
        self.bn = BatchNorm(features)
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T, F]
        return self.conv_bn_act(self._conv, x)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        c = self.conv
        x = x.to(cd)
        if self.causal and self.time_pad:
            # (2e, 0) in time; frequency keeps the conv's symmetric padding
            x = nn.functional.pad(x, (0, 0, 2 * self.time_pad, 0))
        return nn.functional.conv2d(
            x, c.weight.to(cd), c.bias.to(cd), padding=c.padding, dilation=c.dilation
        )

    def conv_bn_act(self, conv: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
        """BatchNorm + activation of ``conv(x)``, the block's raw conv output
        ``[B, C, T, F]``.  In train mode with `remat_convs_enabled` the three
        run under ``torch.utils.checkpoint``, so the backward recomputes them
        from `x`; the running statistics move once either way."""
        if not self.training:
            return self.bn_act(conv(x))
        if remat_convs_enabled():
            # nothing in a block draws random numbers: no RNG state to keep
            y, mean, var = checkpoint(lambda x: self._bn_act_train(conv(x)), x,
                                      use_reentrant=False, preserve_rng_state=False)
        else:
            y, mean, var = self._bn_act_train(conv(x))
        self.bn.update_running(mean, var)
        return y

    def _bn_act_train(self, y: torch.Tensor):
        bn = self.bn
        return bn_act_train(y, bn.scale, bn.bias, self.activation, bn.epsilon)

    def bn_act(self, y: torch.Tensor) -> torch.Tensor:
        """BatchNorm + activation of the raw conv output ``[B, C, T, F]``."""
        bn = self.bn
        if self.training:
            y, mean, var = self._bn_act_train(y)
            bn.update_running(mean, var)
            return y
        return bn_act_eval(y, bn.scale, bn.bias, bn.mean, bn.var, self.activation, bn.epsilon)


class MaskNet(nn.Module):
    """Speaker-conditioned soft-mask network (train or eval mode); with
    `streaming` a forward-only LSTM with a carry, with `causal` a conv stack
    without lookahead."""

    def __init__(
        self,
        num_freq: int = 601,
        emb_dim: int = 256,
        lstm_dim: int = 400,
        fc1_dim: int = 600,
        fc2_dim: int = 601,
        conv_channels: int = 64,
        conv_out_channels: int = 8,
        activation: str = "relu",
        num_extra_dilated_blocks: int = 0,
        compute_dtype=torch.float32,
        dropout: float = 0.0,
        streaming: bool = False,
        causal: bool = False,
    ):
        super().__init__()
        self.num_freq = num_freq
        self.dropout = float(dropout)
        self.streaming = streaming
        self.causal = causal
        self.emb_dim = emb_dim
        self.conv_channels = conv_channels
        self.conv_out_channels = conv_out_channels
        self.compute_dtype = compute_dtype
        specs = CONV_SPECS + extra_dilated_specs(num_extra_dilated_blocks) + [((1, 1), (1, 1))]
        self.block_names = [f"conv{i + 1}" for i in range(len(specs))]
        for i, ((k, d), name) in enumerate(zip(specs, self.block_names)):
            cin = 1 if i == 0 else conv_channels
            cout = conv_out_channels if i == len(specs) - 1 else conv_channels
            self.add_module(name, ConvBlock(cout, cin, k, d, activation, compute_dtype, causal))
        lstm = UniLSTM if streaming else BiLSTM
        self.lstm = lstm(conv_out_channels * num_freq + emb_dim, lstm_dim, compute_dtype)
        self.fc1 = nn.Linear(lstm_dim if streaming else 2 * lstm_dim, fc1_dim)
        self.fc2 = nn.Linear(fc1_dim, fc2_dim)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return x @ layer.weight.to(cd).t() + layer.bias.to(cd)

    @property
    def conv_context(self) -> int:
        """One side of the stack's time receptive field, the sum of its
        layers' half extents: 3 + 2 + 4 + 8 + 16 + 32 = 65 frames, and 64
        more for each extra dilated block (JAX `masknet.py:47-54, :424-428`)."""
        return sum(getattr(self, name).time_pad for name in self.block_names)

    @property
    def conv_context_left(self) -> int:
        """Past frames each output frame depends on: a causal stack folds
        its whole receptive field into the past."""
        return 2 * self.conv_context if self.causal else self.conv_context

    @property
    def conv_context_right(self) -> int:
        """Future frames each output frame depends on (the streaming
        lookahead); 0 when causal."""
        return 0 if self.causal else self.conv_context

    def conv_features(self, spec: torch.Tensor,
                      edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[B, T, F]`` → flattened conv features ``[B, T, 8F]`` (f·C + c).

        `edge_mask` (``[B or 1, T]``, 0/1): frames marked 0 are zeroed at the
        input and after every block, so they act exactly as the zero padding
        of a pass over the valid frames alone (JAX `masknet.py:443-505`); the
        sequence-parallel engine (`parallel/sequence.py`) marks its halos
        outside the utterance and its alignment padding so.  An all-ones mask
        leaves the output's bits unchanged.  The fused chain takes none."""
        with span("voicesplit.convs"):
            B, T, F = spec.shape
            mask = None
            if edge_mask is not None:
                mask = edge_mask.to(self.compute_dtype)[:, None, :, None]  # [B or 1, 1, T, 1]

            def apply_mask(h):
                return h if mask is None else h * mask

            x = apply_mask(spec.to(self.compute_dtype)[:, None])  # [B, 1, T, F]
            if self.causal:
                # the library conv only: the conv kernels compute "same" convs
                for name in self.block_names:
                    x = apply_mask(getattr(self, name)(x))
            elif pallas_conv_enabled():
                if self._use_fused_chain():
                    raise ValueError(
                        "VOICESPLIT_PALLAS_CONV=1 and VOICESPLIT_FUSED_CHAIN=1 are both set: "
                        "a training forward takes one conv path, not both"
                    )
                x = self._dilated_conv_features(x, apply_mask)
            elif self._use_fused_chain():
                if mask is not None:
                    raise NotImplementedError("edge_mask is not supported by the fused conv chain")
                x = self._fused_chain_features(x)
            else:
                for name in self.block_names:
                    x = apply_mask(getattr(self, name)(x))
            return x.permute(0, 2, 3, 1).reshape(B, T, F * self.conv_out_channels)

    def _use_fused_chain(self) -> bool:
        """The JAX model's conditions (`masknet.py:385-395`): train mode, not
        causal, the switch, and a channel count that the folded TPU layout
        takes; the chain's CUDA kernels take every such count."""
        return (
            self.training and not self.causal and fused_chain_enabled()
            and (2 * self.conv_channels) % 128 == 0
        )

    def _fused_chain_features(self, x: torch.Tensor) -> torch.Tensor:
        """``conv1`` as usual, the convs of every block between it and the
        1×1 projection (``conv2`` … ``conv7`` and any extra dilated block)
        as one fused chain, the last chain block's BatchNorm + activation on
        the chain's raw output (it takes the statistics again), the
        projection as usual."""
        blocks = [getattr(self, name) for name in self.block_names]
        chain_blocks = blocks[1:-1]
        specs = [(b.conv.kernel_size, b.conv.dilation[0]) for b in chain_blocks]
        chain = make_chain(specs, chain_blocks[0].activation, chain_blocks[0].bn.epsilon)
        y1 = blocks[0](x).permute(0, 2, 3, 1)  # [B, T, F, C]
        raw, means, vars_ = chain(
            y1,
            # OIHW → [kt, kf, Cin, Cout]
            tuple(b.conv.weight.permute(2, 3, 1, 0) for b in chain_blocks),
            tuple(b.conv.bias for b in chain_blocks),
            tuple(b.bn.scale for b in chain_blocks[:-1]),
            tuple(b.bn.bias for b in chain_blocks[:-1]),
        )
        for b, mean, var in zip(chain_blocks[:-1], means, vars_):
            b.bn.update_running(mean, var)
        h = chain_blocks[-1].bn_act(raw.permute(0, 3, 1, 2))  # a channels-last NCHW view
        return blocks[-1](h)

    def _dilated_conv_features(self, x: torch.Tensor, apply_mask) -> torch.Tensor:
        """Every block in turn, `apply_mask` after each; a layer that
        `conv_cuda.takes_layer` accepts runs on channels-last ``[B, T, F,
        C]``: in eval mode the whole block as one `conv_cuda.conv2d_bn_act_eval`,
        in train mode its conv through `conv_cuda.conv2d_dilated_bias`.  The
        first such layer copies NCHW to channels-last; after it every output
        keeps that memory layout, so the later permutes are views."""
        for name in self.block_names:
            block = getattr(self, name)
            c = block.conv
            w_shape = (*c.kernel_size, c.in_channels, c.out_channels)
            if takes_layer(w_shape, c.dilation) and not block.training:
                y = conv2d_bn_act_eval(
                    x.to(self.compute_dtype).permute(0, 2, 3, 1).contiguous(),
                    c.weight.permute(2, 3, 1, 0),  # OIHW → [kt, kf, Cin, Cout]
                    c.bias, block.bn, block.activation, c.dilation,
                )
                x = apply_mask(y.permute(0, 3, 1, 2))
            elif takes_layer(w_shape, c.dilation):
                def conv(x, c=c):
                    y = conv2d_dilated_bias(
                        x.to(self.compute_dtype).permute(0, 2, 3, 1).contiguous(),
                        c.weight.permute(2, 3, 1, 0),  # OIHW → [kt, kf, Cin, Cout]
                        c.bias, c.dilation,
                    )
                    return y.permute(0, 3, 1, 2)

                x = apply_mask(block.conv_bn_act(conv, x))
            else:
                x = apply_mask(block(x))
        return x

    def draw_dropout_keep(self, shape, keep_prob: float,
                          generator: torch.Generator) -> torch.Tensor:
        """One dropout site's keep mask: bool, True with `keep_prob`."""
        return torch.rand(shape, generator=generator, device=generator.device) < keep_prob

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        if not self.training or self.dropout == 0.0:
            return x
        if self.dropout == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError(
                f"a train-mode forward with dropout {self.dropout} needs a dropout_generator")
        keep_prob = 1.0 - self.dropout
        keep = self.draw_dropout_keep(tuple(x.shape), keep_prob, generator).to(x.device)
        return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype), 0.0)

    def mask_head(self, features: torch.Tensor, emb: torch.Tensor,
                  dropout_generator: Optional[torch.Generator] = None,
                  lstm_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The mask ``[B, T, F]`` (fp32); a streaming model returns
        ``(mask, (h, c))``, the LSTM's carry after the last frame."""
        with span("voicesplit.head"):
            B, T, _ = features.shape
            cd = self.compute_dtype
            emb_t = emb.to(cd)[:, None, :].expand(B, T, self.emb_dim)
            x = torch.cat([features, emb_t], dim=-1)  # [B, T, 8F + emb]
            x = self._drop(x, dropout_generator)
            with span("voicesplit.lstm"):
                if self.streaming:
                    x, carry = self.lstm(x, lstm_carry)
                else:
                    x = self.lstm(x)
            x = torch.relu(x)  # post-LSTM ReLU of both reference models
            x = self._drop(x, dropout_generator)
            x = torch.relu(self._dense(self.fc1, x))
            mask = torch.sigmoid(self._dense(self.fc2, x).float())  # fp32 [B, T, F]
            return (mask, carry) if self.streaming else mask

    def forward(self, spec: torch.Tensor, emb: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                lstm_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        return self.mask_head(self.conv_features(spec), emb, dropout_generator, lstm_carry)


def make_masknet(config: Config, streaming: bool = False, device: DeviceLike = None) -> MaskNet:
    """Build the model selected by ``config.model_name`` ("voicefilter" ⇒
    relu, "voicesplit" ⇒ mish), causal as ``config.model.causal`` says and
    with the streaming LSTM when `streaming`, on `device` (the CUDA card by
    default), in eval mode."""
    m = config.model
    dev = resolve_device(device)
    model = MaskNet(
        num_freq=config.audio.active.num_freq,
        emb_dim=m.emb_dim,
        lstm_dim=m.lstm_dim,
        fc1_dim=m.fc1_dim,
        fc2_dim=m.fc2_dim,
        conv_channels=m.conv_channels,
        conv_out_channels=m.conv_out_channels,
        activation="relu" if config.model_name == "voicefilter" else "mish",
        num_extra_dilated_blocks=m.num_extra_dilated_blocks,
        compute_dtype=getattr(torch, config.train_config.compute_dtype),
        dropout=m.dropout,
        streaming=streaming,
        causal=m.causal,
    )
    return model.to(dev).eval()
