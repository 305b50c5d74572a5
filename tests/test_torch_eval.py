"""The port's evaluation (`voicesplit_tpu_torch/eval/`) against the JAX
package's (`voicesplit_tpu/eval/`): host SDR / SI-SNRi, their batched
versions, and `validate` over one loader.
"""

import json
import pathlib

import numpy as np
import pytest
import scipy.signal
import torch

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data import dataset as jds
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.eval import metrics as jmetrics
from voicesplit_tpu.eval.validation import validate as jax_validate
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data import dataset as tds
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.eval import metrics as tmetrics
from voicesplit_tpu_torch.eval.validation import validate
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train import make_eval_step
from voicesplit_tpu_torch.utils.logging import MetricsLogger

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _signals(seed, batch=3, n=6000):
    """Low-passed noise as the 'speech' (a coloured autocorrelation, as the
    Toeplitz solve meets it on real signals), an estimate with a short echo
    and noise, and a mixture."""
    rng = np.random.default_rng(seed)
    b, a = scipy.signal.butter(4, 0.25)
    target = scipy.signal.lfilter(b, a, rng.standard_normal((batch, n))).astype(np.float32)
    other = scipy.signal.lfilter(b, a, rng.standard_normal((batch, n))).astype(np.float32)
    est = target + 0.3 * np.roll(target, 5, axis=1) + 0.15 * rng.standard_normal((batch, n)).astype(np.float32)
    lengths = np.array([n, n - 1500, n // 2][:batch], np.int32)
    return est.astype(np.float32), target, (target + other).astype(np.float32), lengths


def test_host_metrics_are_the_jax_packages():
    est, target, mixture, lengths = _signals(0)
    for i, n in enumerate(lengths):
        e, t, m = est[i, :n], target[i, :n], mixture[i, :n]
        assert tmetrics.bss_eval_sdr(t, e) == jmetrics.bss_eval_sdr(t, e)
        assert tmetrics.si_snr_improvement(e, t, m) == jmetrics.si_snr_improvement(e, t, m)
        assert tmetrics.sdr_improvement(e, t, m) == jmetrics.sdr_improvement(e, t, m)
    assert tmetrics.bss_eval_sdr(target[0], target[0]) > 60.0


def test_batched_sdr_matches_jax_and_the_host_path():
    """float32 Cholesky with one refinement step on both sides: 0.02 dB
    between the packages, 0.05 dB to the float64 host path (the JAX
    package's own test holds 0.01 dB on speech)."""
    est, target, _, lengths = _signals(1)
    got = tmetrics.bss_eval_sdr_batch(target, est, lengths)
    want = jmetrics.bss_eval_sdr_batch(target, est, lengths)
    host = [tmetrics.bss_eval_sdr(target[i, :n], est[i, :n]) for i, n in enumerate(lengths)]
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.02)
    np.testing.assert_allclose(got, host, atol=0.05)


def test_batched_si_snri_matches_jax_and_the_host_path():
    est, target, mixture, lengths = _signals(2)
    got = tmetrics.si_snr_improvement_batch(est, target, mixture, lengths)
    want = jmetrics.si_snr_improvement_batch(est, target, mixture, lengths)
    host = [tmetrics.si_snr_improvement(est[i, :n], target[i, :n], mixture[i, :n])
            for i, n in enumerate(lengths)]
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, host, atol=1e-3)


@pytest.mark.parametrize("est_len", [5000, 6000, 6400])
def test_fused_batch_metrics_pad_or_crop_the_estimate(est_len):
    """`sdr_and_si_snri_batch` against the JAX package's fused function for an
    estimate shorter than, as long as and longer than the target."""
    import jax.numpy as jnp

    est, target, mixture, lengths = _signals(3)
    est = np.pad(est, ((0, 0), (0, 400)))[:, :est_len]
    sdr, snri = tmetrics.sdr_and_si_snri_batch(
        *(torch.from_numpy(a) for a in (est, target, mixture, lengths)))
    jsdr, jsnri = jmetrics._sdr_and_si_snri_batch(
        jnp.asarray(est), jnp.asarray(target), jnp.asarray(mixture), jnp.asarray(lengths))
    np.testing.assert_allclose(sdr.numpy(), np.asarray(jsdr), atol=0.02)
    np.testing.assert_allclose(snri.numpy(), np.asarray(jsnri), atol=1e-3)


def test_short_signal_takes_a_shorter_filter():
    """Fewer samples than filter taps: the filter shrinks to the signal, as
    in the JAX package."""
    est, target, _, _ = _signals(4, batch=2, n=300)
    lengths = np.array([300, 200], np.int32)
    got = tmetrics.bss_eval_sdr_batch(target, est, lengths)
    want = jmetrics.bss_eval_sdr_batch(target, est, lengths)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=0.1)


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

AUDIO_LEN, EMB = 0.25, 16


def _config_text(data_dir):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=32, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = AUDIO_LEN
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=EMB)
    d["train_config"].update(compute_dtype="float32")
    d["test_config"] = {"batch_size": 2}
    d["dataset"].update(train_dir=str(data_dir), test_dir=str(data_dir))
    return json.dumps(d)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_triplets")
    text = _config_text(root)
    jc, tc = jax_config(text), load_config_from_str(text)
    build_synthetic_dataset(str(root), 5, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=tc.dataset.format, seed=6)
    model = make_masknet(tc, device="cpu")
    params, stats = weights.random_jax_variables(model, 2)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    tap, jap = make_audio_processor(tc, device="cpu"), jax_audio_processor(jc)
    jstep = jax_steps.make_eval_step(jc, jax_make_masknet(jc), jap)
    return {
        "port": (make_eval_step(tc, model, tap), lambda: tds.test_dataloader(tc, tap)),
        "jax": (jstep, params, stats, lambda: jds.test_dataloader(jc, jap)),
    }


@pytest.mark.parametrize("max_items", [None, 3])
def test_validate_matches_jax_on_one_loader(max_items, eval_setup):
    """5 items at batch 2 (a padded last batch), host SDR on both sides
    (fp32 models from the same weights): loss and SI-SNR to 1e-3, SDR and
    SI-SNRi to 0.02 dB."""
    tstep, tloader = eval_setup["port"]
    jstep, params, stats, jloader = eval_setup["jax"]
    got = validate(tstep, tloader(), max_items=max_items)
    want = jax_validate(jstep, params, stats, jloader(), max_items=max_items, sdr_backend="host")
    assert sorted(got) == sorted(want) == ["loss", "sdr", "si_snr", "si_snri"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    np.testing.assert_allclose(got["si_snr"], want["si_snr"], atol=1e-3)
    np.testing.assert_allclose(got["sdr"], want["sdr"], atol=0.02)
    np.testing.assert_allclose(got["si_snri"], want["si_snri"], atol=0.02)


def test_validate_backends_agree_and_auto_is_host_on_the_cpu(eval_setup, monkeypatch):
    """The batched projection that `validate` takes on the card, run here
    over the same batches, meets the host projection it takes on the CPU:
    SDR to 0.05 dB, SI-SNRi to 1e-3 dB."""
    tstep, tloader = eval_setup["port"]
    host = validate(tstep, tloader())
    loader, sdrs, snris = tloader(), [], []
    for _ in range(loader.batches_per_epoch()):
        batch = next(loader)
        n_valid = int(batch.get("n_valid", loader.batch_size))
        out = tstep({k: v for k, v in batch.items() if k != "n_valid"})
        sdr, snri = tmetrics.sdr_and_si_snri_batch(
            out["est_wav"], *(torch.as_tensor(batch[k]) for k in ("target_wav", "mixed_wav", "wav_len")))
        sdrs.extend(sdr[:n_valid].tolist())
        snris.extend(snri[:n_valid].tolist())
    assert len(sdrs) == 5
    np.testing.assert_allclose(np.mean(sdrs), host["sdr"], atol=0.05)
    np.testing.assert_allclose(np.mean(snris), host["si_snri"], atol=1e-3)
    import voicesplit_tpu_torch.eval.validation as tv

    monkeypatch.setattr(tv, "sdr_and_si_snri_batch",
                        lambda *a: pytest.fail("the device backend ran for CPU tensors"))
    assert validate(tstep, tloader()) == host
    fast = validate(tstep, tloader(), compute_sdr=False)
    assert sorted(fast) == ["loss", "si_snr"] and fast["loss"] == host["loss"]


def test_validate_logs_scalars_and_one_sample(eval_setup, tmp_path):
    tstep, tloader = eval_setup["port"]
    logger = MetricsLogger(str(tmp_path), 16000, enable_tb=False)
    result = validate(tstep, tloader(), logger, step=7)
    logger.close()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(set(r) - {"step", "time"}) for r in records] == [
        ["SDR", "test_loss"], ["eval_loss", "eval_sdr", "eval_si_snr", "eval_si_snri"]]
    assert all(r["step"] == 7 for r in records)
    assert records[1]["eval_sdr"] == result["sdr"]
    silent = MetricsLogger(str(tmp_path / "off"), enabled=False)
    silent.log_training(1.0, 1)
    silent.close()
    assert not (tmp_path / "off").exists()
