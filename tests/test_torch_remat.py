"""``VOICESPLIT_REMAT_CONV=1`` (`voicesplit_tpu_torch/models/masknet.py`): each
conv block recomputed in the backward.  A remat step against the plain step,
bit for bit, on every CPU route; the running statistics, moved once, against
the JAX package's with the switch set; the block forwards a train step and an
eval pass run; the trainer and the training CLI under the switch.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model_parallel import HOP, L, SR, _batch
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import train as train_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models import masknet
from voicesplit_tpu_torch.models.masknet import ConvBlock, MaskNet, make_masknet
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from voicesplit_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint
from voicesplit_tpu_torch.train.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(channels=8, causal=False, root=None):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / SR
    d["model"].update(conv_channels=channels, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16,
                      causal=causal)
    d["train_config"].update(compute_dtype="float32", learning_rate=1e-3)
    if root is not None:
        d["train_config"].update(batch_size=2, seed=3, epochs=1, summary_interval=1,
                                 check_interval=1, checkpoint_interval=2)
        d["dataset"].update(train_dir=str(root / "train"), test_dir=str(root / "test"))
    return json.dumps(d)


# route: (switches, conv channels, causal convs, streaming LSTM).  The JAX
# package's conditions send a layer to the dilated kernel at 64 channels or
# more and to the chain at a multiple of 64: those routes run at 64.
ROUTES = {
    "library": ({}, 8, False, False),
    "causal": ({}, 8, True, False),
    "streaming": ({}, 8, True, True),
    "dilated": ({"VOICESPLIT_PALLAS_CONV": "1"}, 64, False, False),
    "fused_chain": ({"VOICESPLIT_FUSED_CHAIN": "1"}, 64, False, False),
}


def _two_steps(route, remat, monkeypatch):
    switches, channels, causal, streaming = ROUTES[route]
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VOICESPLIT_REMAT_CONV", "1" if remat else "0")
    tc = load_config_from_str(_config_text(channels, causal))
    model = weights.init_random_(make_masknet(tc, streaming=streaming, device="cpu"), 0)
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    step = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), optimizer)
    losses = [float(step(state, _batch(2, seed=10 + i))["loss"]) for i in range(2)]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    moments = {k: optimizer.state[p]["exp_avg_sq"].clone() for k, p in model.named_parameters()}
    return losses, grads, dict(model.state_dict()), moments


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_remat_step_equals_the_plain_step(route, monkeypatch):
    """Two train steps with the switch on and off from the same weights: the
    losses, the last step's gradients, the parameters, Adam's moments and
    the running statistics bit for bit (the recompute repeats the forward's
    operations on the same inputs, and the statistics move only in the
    forward)."""
    plain = _two_steps(route, False, monkeypatch)
    remat = _two_steps(route, True, monkeypatch)
    assert remat[0] == plain[0]
    for got, want in zip(remat[1:], plain[1:]):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


DIMS = dict(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33, conv_channels=8)


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_running_statistics_move_once_as_jax_with_remat(activation, monkeypatch):
    """With the switch set for the whole test (flax reads it in ``setup``,
    where it wraps every ConvBlock in ``nn.remat``): one train-mode forward
    and backward of each package from the same weights.  The port's running
    statistics equal JAX's to 1e-6 and its own without the switch bit for
    bit, so they moved once; the gradients agree with JAX's to 1e-5 of the
    largest."""
    monkeypatch.setenv("VOICESPLIT_REMAT_CONV", "1")
    rng = np.random.default_rng(2)
    spec = rng.uniform(0, 1, (2, 32, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((2, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((2, 32, DIMS["num_freq"])).astype(np.float32)

    def port_pass():
        port = MaskNet(activation=activation, **DIMS).train()
        port.load_state_dict(weights.state_dict_from_jax(params, stats))
        (port(torch.from_numpy(spec), torch.from_numpy(emb)) * torch.from_numpy(cot)).sum().backward()
        return port

    params, stats = weights.random_jax_variables(MaskNet(activation=activation, **DIMS), seed=1)
    jm = JaxMaskNet(activation=activation, **DIMS)

    def loss(p):
        mask, upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(spec),
                             jnp.asarray(emb), train=True, mutable=["batch_stats"])
        return jnp.sum(mask * cot), upd["batch_stats"]

    grads, new_stats = jax.grad(loss, has_aux=True)(params)
    port = port_pass()
    monkeypatch.setenv("VOICESPLIT_REMAT_CONV", "0")
    plain = port_pass()
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6, err_msg=k)
            assert torch.equal(v, plain.state_dict()[k]), k
            moved += not torch.equal(v, weights.state_dict_from_jax(params, stats)[k])
    assert moved == 2 * len(port.block_names)
    want_g = weights.params_from_jax(jax.device_get(grads))
    scale = max(float(v.abs().max()) for v in want_g.values())
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("route", ["library", "dilated"])
def test_each_block_forward_runs_twice_in_a_train_step_and_once_in_eval(route, monkeypatch):
    """Counts each block's conv calls (the library conv, or on the dilated
    route the dilated-kernel op of conv2 … conv7: `conv2d_dilated_bias` in
    train mode, the eval-mode block `conv2d_bn_act_eval` in eval mode): a
    remat train step runs every block's forward twice (the forward and the
    recompute), a plain step and an eval pass with the switch once."""
    switches, channels, _, _ = ROUTES[route]
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    calls = {"library": 0, "dilated": 0}
    library_conv = ConvBlock._conv

    def count_library(self, x):
        calls["library"] += 1
        return library_conv(self, x)

    def count_dilated(fn):
        def counted(*a, **kw):
            calls["dilated"] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(ConvBlock, "_conv", count_library)
    for name in ("conv2d_dilated_bias", "conv2d_bn_act_eval"):
        monkeypatch.setattr(masknet, name, count_dilated(getattr(masknet, name)))
    tc = load_config_from_str(_config_text(channels))
    model = weights.init_random_(make_masknet(tc, device="cpu"), 0)
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    ap = make_audio_processor(tc, device="cpu")
    step = make_train_step(tc, model, ap, optimizer)
    n_blocks = len(model.block_names)
    per_pass = {"library": n_blocks, "dilated": 0} if route == "library" else \
        {"library": 2, "dilated": n_blocks - 2}

    def counted(fn):
        calls.update(library=0, dilated=0)
        fn()
        return dict(calls)

    for remat, times in (("0", 1), ("1", 2)):
        monkeypatch.setenv("VOICESPLIT_REMAT_CONV", remat)
        got = counted(lambda: step(state, _batch(2, seed=1)))
        assert got == {k: times * v for k, v in per_pass.items()}, (remat, got)
    model.eval()
    spec = torch.rand(2, 20, 65)
    with torch.no_grad():
        assert counted(lambda: model(spec, torch.randn(2, 16))) == per_pass


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("remat")
    build_synthetic_dataset(str(root / "train"), 4, audio_len=L / SR, emb_dim=16, seed=0)
    build_synthetic_dataset(str(root / "test"), 2, audio_len=L / SR, emb_dim=16, seed=1)
    return root


def _checkpoint_state(path):
    payload = load_checkpoint(path)
    return {**payload["model"], **payload["batch_stats"]}, payload["optimizer"]


def _assert_same_checkpoint(a, b):
    (sa, oa), (sb, ob) = _checkpoint_state(a), _checkpoint_state(b)
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    for i, entry in oa["state"].items():
        for k, v in entry.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_trainer_follows_the_switch(workspace, tmp_path, monkeypatch):
    """`Trainer.fit` for two steps with the switch on and off: the same
    checkpoint bits, and the switch's run ran each block's forward twice a
    step."""
    calls = []
    library_conv = ConvBlock._conv
    monkeypatch.setattr(ConvBlock, "_conv", lambda self, x: calls.append(1) or library_conv(self, x))
    config = load_config_from_str(_config_text(root=workspace))
    runs, per_run = {}, {}
    for remat in ("0", "1"):
        monkeypatch.setenv("VOICESPLIT_REMAT_CONV", remat)
        calls.clear()
        tr = Trainer(config, log_dir=str(tmp_path / remat), enable_tb=False, prefetch_depth=0,
                     async_checkpoint=False, device="cpu")
        try:
            res = tr.fit(max_steps=2, validate_at_epoch_start=False)
        finally:
            tr.close()
        assert res["step"] == 2
        runs[remat] = list_checkpoints(str(tmp_path / remat))
        per_run[remat] = len(calls)
    assert [pathlib.Path(p).name for p in runs["1"]] == ["checkpoint_2.pt"]
    _assert_same_checkpoint(runs["1"][-1], runs["0"][-1])
    n_blocks = 8  # conv1 … conv7 and the projection, on the library route at 8 channels
    evals = per_run["0"] - 2 * n_blocks  # the validation's eval passes, no recompute
    assert per_run["1"] == 2 * 2 * n_blocks + evals


def test_cli_follows_the_switch(workspace, tmp_path, monkeypatch):
    """`cli.train` for two steps with ``VOICESPLIT_REMAT_CONV=1`` in its
    environment: the checkpoint of the run without it, bit for bit."""
    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text(root=workspace))
    paths = {}
    for remat in ("0", "1"):
        monkeypatch.setenv("VOICESPLIT_REMAT_CONV", remat)
        res = train_cli.main(["-c", str(config_path), "--device", "cpu", "--max_steps", "2",
                              "--logs_path", str(tmp_path / f"logs{remat}")])
        assert res["step"] == 2
        paths[remat] = list_checkpoints(str(tmp_path / f"logs{remat}"))[-1]
    _assert_same_checkpoint(paths["1"], paths["0"])
