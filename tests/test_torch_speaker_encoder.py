"""The speaker encoders: the port's `SpeakerEncoder` against the JAX package's.

One numpy input from a seed goes through the JAX module on the CPU (its
`UniLSTM` runs `lax.scan` there: `fused_lstm_scan` is the TPU's) and
through the port with ``device="cpu"`` (the kernels' plain versions); the
JAX parameters (flax's own init) carry across with
`weights.encoder_params_from_jax`.  Both topologies: GE2E (window 80,
stride 40) and CorentinJ (ReLU after the projection, renormalized mean), at
a small width and at full width (H=768 / 256) on 4 windows.  The importers
(`embedder.pt`, CorentinJ's `pretrained.pt`) are held to a
``torch.nn.LSTM`` reference module with random weights, built as
`tests/test_speaker_encoder.py` builds one; the plain LSTM versions to the
Pallas kernels in interpret mode at the encoder's gradient pattern.

Tolerances (fp32): embeddings 2e-5 at the small width and 5e-5 at full
width (unit vectors; summation order over 768 units and 80 steps), the
Pallas kernels 1e-5 (as `tests/test_torch_lstm.py`), the importers 2e-5
(as the JAX package's own import test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import Config as JaxConfig
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models import speaker_encoder as jax_se
from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu.train import encoder as jax_train_encoder
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.speaker_encoder import (
    SpeakerEncoder,
    corentinj_mel,
    load_corentinj_state_dict,
    load_torch_state_dict,
    make_corentinj_encoder,
)
from voicesplit_tpu_torch.ops import lstm_cuda
from voicesplit_tpu_torch.train.encoder import embed_utterance, embed_utterance_windows, embed_windows
from voicesplit_tpu_torch.weights import encoder_params_from_jax, init_encoder_for_training_

SMALL_TOL, FULL_TOL, KERNEL_TOL, IMPORT_TOL = 2e-5, 5e-5, 1e-5, 2e-5

# topology kwargs (JAX names = the port's): small and full width of each
TOPOLOGIES = {
    "ge2e-small": dict(num_mels=40, lstm_hidden=32, lstm_layers=3, emb_dim=16, window=20, stride=10),
    "corentinj-small": dict(num_mels=40, lstm_hidden=24, lstm_layers=3, emb_dim=24, window=16,
                            stride=8, proj_relu=True, final_renorm=True),
    "ge2e-full": dict(),
    "corentinj-full": dict(num_mels=40, lstm_hidden=256, lstm_layers=3, emb_dim=256, window=160,
                           stride=80, proj_relu=True, final_renorm=True),
}


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_encoder_and_params(kw, mel, seed=0):
    enc = jax_se.SpeakerEncoder(**kw)
    params = enc.init(jax.random.PRNGKey(seed), jnp.asarray(mel[:1, :, : enc.window]))["params"]
    return enc, _np_tree(params)


def _port_encoder(kw, params):
    enc = SpeakerEncoder(**kw)
    enc.load_state_dict(encoder_params_from_jax(params))
    return enc


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_encoder_forward_matches_jax(name):
    """Two utterances of 4 windows each (a ragged tail both drop) through
    both packages: the same d-vectors."""
    kw = TOPOLOGIES[name]
    W = kw.get("window", 80)
    S = kw.get("stride", 40)
    rng = np.random.default_rng(len(name))
    mel = rng.standard_normal((2, 40, W + 3 * S + S // 2)).astype(np.float32)
    enc_j, params = _jax_encoder_and_params(kw, mel)
    want = np.asarray(enc_j.apply({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = _port_encoder(kw, params)(torch.from_numpy(mel)).numpy()
    tol = FULL_TOL if name.endswith("full") else SMALL_TOL
    assert got.shape == want.shape == (2, kw.get("emb_dim", 256))
    np.testing.assert_allclose(got, want, atol=tol)
    if kw.get("final_renorm"):
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encoder_state_dict_names_and_layout():
    """JAX names map one to one onto the port's: ``lstm{i}.fwd_*`` in the
    JAX layout, ``proj.weight`` the transposed Dense kernel."""
    kw = TOPOLOGIES["ge2e-small"]
    mel = np.zeros((1, 40, 20), np.float32)
    _, params = _jax_encoder_and_params(kw, mel)
    sd = encoder_params_from_jax(params)
    assert set(sd) == set(SpeakerEncoder(**kw).state_dict())
    np.testing.assert_array_equal(sd["lstm1.fwd_w_hh"].numpy(), params["lstm1"]["fwd_w_hh"])
    np.testing.assert_array_equal(sd["proj.weight"].numpy(), params["proj"]["kernel"].T)
    ge2e = encoder_params_from_jax({"enc": params, "w": np.float32(10.0), "b": np.float32(-5.0)})
    assert ge2e["w"].shape == () and float(ge2e["b"]) == -5.0 and "enc.proj.bias" in ge2e


def test_too_few_frames_raise():
    with pytest.raises(ValueError, match="at least 80"):
        SpeakerEncoder(num_mels=8, lstm_hidden=8)(torch.zeros(1, 8, 79))


def test_window_batched_extraction_matches_direct():
    """Fixed batches of windows, the last padded with zero windows, then
    the host mean: the encoder's own forward over the whole utterance."""
    enc = init_encoder_for_training_(SpeakerEncoder(num_mels=8, lstm_hidden=16, emb_dim=12), 0)
    rng = np.random.default_rng(0)
    T = 80 + 40 * 6 + 17  # 7 windows and a ragged tail
    mel = rng.standard_normal((8, T)).astype(np.float32)
    with torch.no_grad():
        direct = enc(torch.from_numpy(mel)[None])[0].numpy()
    wins = np.stack([mel[:, s * 40 : s * 40 + 80] for s in range(7)])
    batched = embed_windows(enc, wins, batch_windows=3).mean(axis=0)  # 3 + 3 + 1 padded
    np.testing.assert_allclose(batched, direct, atol=1e-6)


@pytest.mark.parametrize("stride", [None, 80], ids=["encoder-stride", "disjoint"])
def test_utterance_embedding_matches_jax(stride):
    """`embed_utterance_windows` (log-mels of each package's processor,
    fixed batches of 4 windows, the last zero-padded) and `embed_utterance`
    against the JAX functions; a clip shorter than a window wraps to one."""
    kw = dict(num_mels=40, lstm_hidden=16, lstm_layers=2, emb_dim=12)
    rng = np.random.default_rng(8)
    wav = (0.1 * rng.standard_normal(int(2.6 * 16000))).astype(np.float32)
    enc_j, params = _jax_encoder_and_params(kw, np.zeros((1, 40, 80), np.float32))
    enc_t = _port_encoder(kw, params)
    ap_j, ap_t = jax_audio_processor(JaxConfig()), make_audio_processor(Config(), device="cpu")
    want = jax_train_encoder.embed_utterance_windows(enc_j, {"enc": params}, ap_j, wav, 4, stride)
    got = embed_utterance_windows(enc_t, ap_t, wav, 4, stride)
    assert got.shape == want.shape == ((5 if stride is None else 3), 12)  # 261 frames
    np.testing.assert_allclose(got, want, atol=SMALL_TOL)
    if stride is None:
        short = wav[: 16000 // 2]
        np.testing.assert_allclose(
            embed_utterance(enc_t, ap_t, short, 4),
            jax_train_encoder.embed_utterance(enc_j, {"enc": params}, ap_j, short, 4), atol=SMALL_TOL)


class _TorchGE2E(torch.nn.Module):
    """The reference notebook's SpeakerEncoder (`GE2E-...-openvoicefilter.py:63-85`)."""

    def __init__(self, num_mels=40, lstm_hidden=32, lstm_layers=3, emb_dim=16, window=20, stride=10):
        super().__init__()
        self.lstm = torch.nn.LSTM(num_mels, lstm_hidden, num_layers=lstm_layers, batch_first=True)
        self.proj = torch.nn.Linear(lstm_hidden, emb_dim)
        self.window, self.stride = window, stride

    def forward(self, mel):  # [M, T]
        mels = mel.unfold(1, self.window, self.stride).permute(1, 2, 0)  # [T', W, M]
        x, _ = self.lstm(mels)
        x = self.proj(x[:, -1, :])
        x = x / torch.norm(x, p=2, dim=1, keepdim=True)
        return x.sum(0) / x.size(0)


class _TorchCorentinJ(torch.nn.Module):
    """The CorentinJ encoder from its public spec: LSTM → Linear → ReLU →
    L2 norm per partial, mean, renorm."""

    def __init__(self, num_mels=40, hidden=24, layers=3, emb_dim=24, window=16, stride=8):
        super().__init__()
        self.lstm = torch.nn.LSTM(num_mels, hidden, num_layers=layers, batch_first=True)
        self.linear = torch.nn.Linear(hidden, emb_dim)
        self.window, self.stride = window, stride

    def forward(self, mel):  # [M, T]
        parts = mel.unfold(1, self.window, self.stride).permute(1, 2, 0)
        _, (h, _) = self.lstm(parts)
        e = torch.relu(self.linear(h[-1]))
        e = e / (torch.norm(e, p=2, dim=1, keepdim=True) + 1e-8)
        raw = e.mean(0)
        return raw / (torch.norm(raw) + 1e-8)


@pytest.mark.parametrize("kind", ["embedder", "corentinj"])
def test_importers_match_a_torch_reference(kind):
    """`load_torch_state_dict` (the reference's ``embedder.pt``, its
    ``proj.linear_layer`` names) and `load_corentinj_state_dict`
    (``pretrained.pt``'s ``model_state``, similarity scalars included)
    reproduce a ``torch.nn.LSTM`` reference module's embedding."""
    torch.manual_seed(3)
    ref = _TorchGE2E() if kind == "embedder" else _TorchCorentinJ()
    ref.eval()
    mel = np.random.default_rng(3).standard_normal((40, 95)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(mel)).numpy()
    sd = ref.state_dict()
    if kind == "embedder":
        sd = {k.replace("proj.", "proj.linear_layer."): v for k, v in sd.items()}
        enc = SpeakerEncoder(**TOPOLOGIES["ge2e-small"])
        enc.load_state_dict(load_torch_state_dict(sd))
    else:
        sd = {**sd, "similarity_weight": torch.tensor([10.0]), "similarity_bias": torch.tensor([-5.0])}
        enc = SpeakerEncoder(**TOPOLOGIES["corentinj-small"])
        enc.load_state_dict(load_corentinj_state_dict(sd))
    with torch.no_grad():
        got = enc(torch.from_numpy(mel)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=IMPORT_TOL)


def test_importer_rejects_a_state_dict_without_an_lstm():
    with pytest.raises(ValueError, match="not a speaker encoder"):
        load_corentinj_state_dict({"linear.weight": np.zeros((2, 2))})


def test_corentinj_mel_and_full_size_encoder():
    """CorentinJ's frontend is the JAX package's to float32 round-off, and
    the full topology embeds 2 s to a unit vector."""
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 16000 * 2).astype(np.float32)
    mel = corentinj_mel(wav)
    want = jax_se.corentinj_mel(wav)
    assert mel.shape == want.shape and mel.shape[0] == 40 and mel.shape[1] >= 160
    np.testing.assert_allclose(mel, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    enc = init_encoder_for_training_(make_corentinj_encoder(device="cpu"), 0)
    with torch.no_grad():
        emb = enc(torch.from_numpy(mel)[None])[0].numpy()
    assert emb.shape == (256,) and abs(float(np.linalg.norm(emb)) - 1.0) < 1e-4


def test_default_device_of_the_corentinj_factory_is_the_card():
    if torch.cuda.is_available():
        assert next(make_corentinj_encoder().parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_corentinj_encoder()


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def test_lstm_plain_versions_match_pallas_kernels_at_the_encoder_gradient_pattern():
    """The encoder's layer in fp32 at 12 rows from the zero state, the top
    layer's cotangent (dhs nonzero at the last step only, no final-state
    cotangent): `lstm_fwd_ref` against `_fwd` and `lstm_bwd_ref` against
    `_bwd` in interpret mode."""
    rng = np.random.default_rng(12)
    T, R, H = 9, 12, 16
    xp = (0.5 * rng.standard_normal((T, R, 4 * H))).astype(np.float32)
    w = rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H)).astype(np.float32)
    zeros = np.zeros((R, H), np.float32)
    dhs = np.zeros((T, R, H), np.float32)
    dhs[-1] = rng.standard_normal((R, H))
    hs_j, cs_j, gates_j = lstm_pallas._fwd(*map(jnp.asarray, (xp, w, zeros, zeros)))
    t = torch.from_numpy
    got = lstm_cuda.lstm_fwd_ref(t(xp), t(w), t(zeros), t(zeros))
    for name, a, b in zip(("hs", "cs", "gates"), got, (hs_j, cs_j, gates_j)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=KERNEL_TOL, err_msg=name)
    prev = lambda s: jnp.concatenate([jnp.zeros((1, R, H)), s[:-1]])  # noqa: E731
    want = lstm_pallas._bwd(jnp.asarray(w), gates_j, prev(cs_j), prev(hs_j), jnp.asarray(dhs),
                            jnp.asarray(zeros), jnp.asarray(zeros), dxp_dtype=jnp.float32)
    got = lstm_cuda.lstm_bwd_ref(t(w), t(_np(gates_j)), t(_np(cs_j)), t(_np(hs_j)), t(zeros),
                                 t(zeros), t(dhs), t(zeros), t(zeros), torch.float32)
    for name, a, b in zip(("dxp", "dwhh", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=KERNEL_TOL, err_msg=name)
