"""The training loop (counterpart of `voicesplit_tpu/train/trainer.py`), on
one card or, data-parallel, one card (or CPU) a process.

Capability of reference `train.py:25-163`: model selection from config,
Adam, checkpoint resume (full or partial warm-start), epoch loop with
validation at epoch start, per-batch step, loss-explosion guard, summaries
every `summary_interval`, checkpoint + validation every
`checkpoint_interval`.

As in the JAX package: waveform batches go to the device from a background
thread (`data/prefetch.py`); the explosion guard reads the metrics on its
own cadence (`check_interval`), so a step does not otherwise wait for the
card; checkpoints carry the data-iterator state for exact mid-epoch resume;
throughput is reported as audio-seconds per second.

Preemption safety: ``fit()`` installs SIGTERM/SIGINT handlers that request a
stop; the loop then checkpoints at the next step boundary and returns
cleanly with ``{"preempted": True}``, so the replacement job resumes
mid-epoch from the saved data-iterator state.

The default train loader is the native C++ loader
(`data/native_loader.py`, ``n_threads = max(2, num_workers)``), as in the
JAX package; it raises where it cannot be built.

NaN triage (``debug_nans=True``): the guard is checked every step and the
pre-step model, optimizer and BatchNorm state is kept (a copy on the card,
about 230 MB at full width); on explosion the failing step is re-run from
that copy on the same device, the forward under `NanOpMode` (a
``TorchFunctionMode`` that raises at the first torch function whose output
is not finite) and the backward under
``torch.autograd.detect_anomaly(check_nan=True)``; ``fit()`` returns the
report under ``"nan_report"``.  The ctypes kernel wrappers are not torch
functions, so a non-finite value out of a kernel is named at the first op
after it.

``streaming=None`` follows ``config.model.causal``, as in the JAX package: a
causal conv stack pairs with the forward-only LSTM (the zero-lookahead
streaming model); ``streaming=False`` trains causal convs under a BiLSTM
head.

Several processes (`parallel/`): once a process group is initialized
(`parallel.initialize_distributed`) every rank builds the same `Trainer`;
``mesh`` is a `parallel.make_mesh` over the ranks, ``(world / model_parallel,
model_parallel)`` by default.  ``batch_size`` is the batch of one data row
(the ranks of a model group share their rows), so the global batch is
``batch_size × data``; the train loader gives each rank its data row's shard
(``shard_id=rank // model, num_shards=data``); the initial state is rank 0's,
broadcast; the step sums the BatchNorm statistics and the gradients over the
data group (`train/steps.py`), so every rank holds the same weights after
each step and the guard sees the same loss on every rank.  With
``model_parallel > 1`` (the gate split, `parallel/sharding.py`) each rank
owns its slices of the split parameters and of their Adam moments, and
gathers the full parameters before each step; it needs a world of a multiple
of ``model_parallel`` processes, so one process raises ``ValueError``, as
the JAX package cannot build that mesh on one device.  Logs, validation and
checkpoints come from rank 0 only, every rank taking part in the collectives
around them (the gathers of the split state among them: the checkpoint holds
the full state, the one-process trainer's file at the same step); a
preemption request on any rank is agreed by an all-gather at the guard's
cadence, so all ranks stop at the same step.  Throughput counts the global
batch.
"""

from __future__ import annotations

import copy
import os
import signal
import threading
import time
import traceback
from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.data.dataset import (
    BatchIterator,
    SeparationDataset,
    discover_samples,
    eval_dataloader,
)
from voicesplit_tpu_torch.data.native_loader import make_train_iterator
from voicesplit_tpu_torch.data.prefetch import DevicePrefetcher
from voicesplit_tpu_torch.device import DeviceLike
from voicesplit_tpu_torch.dsp.processor import AudioProcessor, make_audio_processor
from voicesplit_tpu_torch.eval.validation import validate
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.parallel.mesh import comm_device, group_active, make_mesh, rank, world_size
from voicesplit_tpu_torch.parallel.sharding import put_batch, shard_train_state
from voicesplit_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    optimizer_state_dict,
    restore_train_state,
    save_checkpoint,
)
from voicesplit_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from voicesplit_tpu_torch.train.steps import make_eval_step, make_train_step
from voicesplit_tpu_torch.utils.logging import MetricsLogger
from voicesplit_tpu_torch.weights import init_for_training_

# what fit() spends its wall time on, by the host's clock (see `Trainer.wall_seconds`)
_WALL_KEYS = ("data", "train_step", "check", "checkpoint", "validation")


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class NanOpMode(TorchFunctionMode):
    """Raises FloatingPointError at the first torch function whose output
    holds a non-finite float.  An output that is one of its inputs (an
    in-place update, ``as_tensor`` of a tensor) and an attribute read (e.g.
    ``.grad``) are no new values and are skipped.  Every op waits for the
    device: a triage mode."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "__name__", None) == "__get__":
            return out
        inputs = list(_tensors((args, kwargs)))
        for t in _tensors(out):
            if not t.is_floating_point() or any(t is i for i in inputs):
                continue
            if not bool(torch.isfinite(t).all()):
                seen = "an input was already non-finite" if any(
                    i.is_floating_point() and not bool(torch.isfinite(i).all()) for i in inputs
                ) else "every input was finite"
                name = getattr(func, "__qualname__", None) or getattr(func, "__name__", str(func))
                raise FloatingPointError(
                    f"nan or inf in the output of {name} (shape {tuple(t.shape)}, "
                    f"{t.dtype}; {seen})")
        return out


class Trainer:
    def __init__(
        self,
        config: Config,
        checkpoint_path: Optional[str] = None,
        log_dir: Optional[str] = None,
        mesh=None,
        model_parallel: int = 1,
        train_loader: Optional[BatchIterator] = None,
        eval_loader: Optional[BatchIterator] = None,
        enable_tb: bool = True,
        prefetch_depth: int = 2,
        debug_nans: bool = False,
        streaming: Optional[bool] = None,
        async_checkpoint: bool = True,
        device: DeviceLike = None,
    ):
        world = world_size()
        if model_parallel > 1 and world % model_parallel:
            raise ValueError(
                f"model_parallel={model_parallel} needs a world of a multiple of "
                f"{model_parallel} processes; the world has {world}")
        mesh = mesh or make_mesh(model=model_parallel)
        if model_parallel > 1 and mesh.model != model_parallel:
            raise ValueError(f"model_parallel={model_parallel} with a mesh of model={mesh.model}")
        if mesh.size != world:
            raise ValueError(f"a mesh of {mesh.size} ranks for a world of {world}")
        self.mesh = mesh
        self.rank, self.world = rank(), world
        self.model_parallel = mesh.model > 1
        data_index = mesh.coords(self.rank)[0]
        self.config = config
        self.log_dir = log_dir or config.train_config.logs_path
        self.ap: AudioProcessor = make_audio_processor(config, device=device)
        self.device = self.ap.device
        self.streaming = config.model.causal if streaming is None else streaming
        self.model = init_for_training_(
            make_masknet(config, streaming=self.streaming, device=device),
            config.train_config.seed,
        )

        if train_loader is None:
            samples = discover_samples(config.dataset.train_dir, config.dataset.format)
            ds = SeparationDataset(samples, self.ap, config.audio.audio_len, config.model.emb_dim)
            train_loader = make_train_iterator(
                ds, config.train_config.batch_size, seed=config.train_config.seed,
                shard_id=data_index, num_shards=mesh.data,
                n_threads=max(2, config.train_config.num_workers),
            )
        self.train_loader = train_loader
        self.eval_loader = eval_loader or eval_dataloader(config, self.ap)

        optimizer = make_optimizer(config, self.model)
        state = create_train_state(self.model, optimizer)
        if checkpoint_path:
            payload = load_checkpoint(checkpoint_path)
            try:
                restored, data_state = restore_train_state(payload, state)
            except ValueError as e:  # name or shape mismatch ⇒ partial warm start
                print(f" > Full restore failed ({e}); partial init")
                state, _ = restore_train_state(
                    payload, state, partial=True,
                    reinit_layers=config.train_config.reinit_layers,
                )
            else:
                # outside the except scope: a loader/data-state problem
                # must surface loudly, not silently discard a good full
                # restore (resetting step + Adam moments) as "mismatch"
                state = restored
                if data_state is not None:
                    self.train_loader.load_state(data_state)
                print(f" > Resumed checkpoint step {int(payload['step'])}")
        self.state: TrainState = shard_train_state(state, self.mesh, self.model_parallel)

        self.train_step = make_train_step(config, self.model, self.ap, self.state.optimizer)
        self.eval_step = make_eval_step(config, self.model, self.ap, self.state)
        self.logger = MetricsLogger(self.log_dir, self.ap.sample_rate, enable_tb=enable_tb,
                                    enabled=self.rank == 0)
        self._audio_seconds_per_batch = (
            config.train_config.batch_size * config.audio.audio_len * mesh.data)
        self._prefetch_depth = prefetch_depth
        self._prefetch: Optional[DevicePrefetcher] = None  # built lazily at
        # fit() so checkpoint restore above can rewind the loader before
        # readahead starts
        self._preempt_requested = False
        self._ckpt_writer = AsyncCheckpointer() if async_checkpoint and self.rank == 0 else None
        self.debug_nans = debug_nans
        # host-clock seconds of the last fit() by what the loop was doing;
        # "train_step" is the time to enqueue the steps and "check" the wait
        # for the card when the guard reads the metrics, so with
        # check_interval = 1 the two together are the train steps' time
        self.wall_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------

    def request_preemption(self) -> None:
        """Ask ``fit()`` to checkpoint and return at the next step boundary."""
        self._preempt_requested = True

    def _handle_signal(self, signum, frame):  # noqa: ARG002 — signal API
        if self._preempt_requested:
            # second signal: the operator means it — escalate past the
            # graceful path (default KeyboardInterrupt semantics)
            raise KeyboardInterrupt
        # os.write is async-signal-safe; print() can die on the stdout
        # BufferedWriter lock if the signal lands mid-write
        os.write(2, f" > Caught signal {signum}: checkpointing at next step boundary\n".encode())
        self.request_preemption()

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT → graceful checkpoint-and-exit.

        Python only allows signal handlers on the main thread; inside a
        worker thread (tests, notebook executors) this is a no-op and
        `request_preemption()` remains the programmatic path.
        """
        if threading.current_thread() is not threading.main_thread():
            return []
        previous = []
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                previous.append((signum, signal.signal(signum, self._handle_signal)))
            except (ValueError, OSError):  # non-main interpreter contexts
                pass
        return previous

    def _preempt_agreed(self) -> bool:
        """Whether any rank was asked to stop (an all-gather of the flags; a
        signal may reach one process only)."""
        flag = torch.tensor([self._preempt_requested], dtype=torch.int32, device=comm_device())
        flags = [torch.empty_like(flag) for _ in range(self.world)]
        torch.distributed.all_gather(flags, flag)
        return bool(torch.cat(flags).any())

    def _put(self, batch):
        return put_batch(self.mesh, batch, self.device)

    def _checkpoint(self, run_eval: bool, step: int, compute_sdr: bool, max_eval_items):
        """Save (optionally + eval), from rank 0 only; under the gate split
        every rank first gathers the full state with the others."""
        t0 = time.perf_counter()
        optimizer_state = None
        if self.state.shards is not None:
            self.state.gather_()
            optimizer_state = optimizer_state_dict(self.state)
        if self.rank != 0:
            return
        data_state = (
            self._prefetch.state if self._prefetch is not None else self.train_loader.state
        )
        if self._ckpt_writer is not None:
            # serialization + disk write overlap the next train steps;
            # fit() flushes the writer before returning
            path = self._ckpt_writer.save(self.log_dir, self.state, self.config, data_state,
                                          optimizer_state=optimizer_state)
        else:
            path = save_checkpoint(self.log_dir, self.state, self.config, data_state,
                                   optimizer_state=optimizer_state)
        print(f"Saved checkpoint to: {path}")
        self.wall_seconds["checkpoint"] += time.perf_counter() - t0
        if run_eval:
            self._validate(step, compute_sdr, max_eval_items)

    def _pre_step_copy(self):
        """The step counter, model (parameters and BatchNorm statistics) and
        optimizer state, copied on their device."""
        st = self.state
        st.gather_()  # the step would gather first anyway
        return (st.step, {k: v.detach().clone() for k, v in st.model.state_dict().items()},
                copy.deepcopy(st.optimizer.state_dict()))

    def _locate_nan(self, pre_step, batch) -> str:
        """Re-run the failing step from the pre-step copy: the forward under
        `NanOpMode`, the backward under autograd's anomaly mode; returns a
        report naming the first op with a non-finite output, with the
        traceback."""
        print(" > debug_nans: re-running the failing step op by op...")
        st = self.state
        st.step, model_sd, opt_sd = pre_step
        st.model.load_state_dict(model_sd)
        if st.shards is not None:
            st.shards.load_from_model_()
        st.optimizer.load_state_dict(opt_sd)
        st.optimizer.zero_grad(set_to_none=True)  # the failed step's gradients
        try:
            with torch.autograd.detect_anomaly(check_nan=True), NanOpMode():
                self.train_step(st, batch)
        except (FloatingPointError, RuntimeError) as e:
            tb = traceback.format_exc()
            print(tb)
            bad = [k for k, v in batch.items()
                   if torch.is_floating_point(torch.as_tensor(v))
                   and not bool(torch.isfinite(torch.as_tensor(v)).all())]
            note = f"the batch's {', '.join(bad)} hold non-finite values\n" if bad else ""
            return f"{e}\n{note}{tb}"
        return ("no non-finite value reproduced: the loss exceeded the guard's threshold "
                "without a non-finite intermediate")

    def _validate(self, step: int, compute_sdr: bool, max_eval_items) -> None:
        self.state.gather_()  # every rank: a collective under the gate split
        if self.rank != 0:
            return
        t0 = time.perf_counter()
        m = validate(
            self.eval_step, self.eval_loader, self.logger, step,
            max_items=max_eval_items, compute_sdr=compute_sdr,
        )
        print(f" > Eval @ step {step}: {m}")
        self.wall_seconds["validation"] += time.perf_counter() - t0

    def fit(
        self,
        max_steps: Optional[int] = None,
        validate_at_epoch_start: bool = True,
        compute_sdr_in_eval: bool = False,
        max_eval_items: Optional[int] = 8,
    ) -> Dict[str, float]:
        """Run the epoch loop; returns the last metrics."""
        c = self.config.train_config
        restore_handlers = self._install_signal_handlers()
        if self._prefetch is None and self._prefetch_depth > 0:
            # assembles + device-places batches on a background thread so
            # host work and the copy to the card overlap the device step
            self._prefetch = DevicePrefetcher(
                self.train_loader, place=self._put, depth=self._prefetch_depth
            )
        step = self.state.step
        last: Dict[str, float] = {}
        wall = self.wall_seconds = {k: 0.0 for k in _WALL_KEYS}
        t_fit = t_window = time.perf_counter()
        steps_in_window = 0
        several = group_active()
        try:
            for _epoch in range(c.epochs):
                if validate_at_epoch_start:
                    self._validate(step, compute_sdr_in_eval, max_eval_items)
                for _ in range(self.train_loader.batches_per_epoch()):
                    t0 = time.perf_counter()
                    if self._prefetch is not None:
                        batch = next(self._prefetch)
                    else:
                        batch = self._put(next(self.train_loader))
                    t1 = time.perf_counter()
                    pre_step = self._pre_step_copy() if self.debug_nans else None
                    metrics = self.train_step(self.state, batch)
                    t2 = time.perf_counter()
                    wall["data"] += t1 - t0
                    wall["train_step"] += t2 - t1
                    step += 1
                    steps_in_window += 1

                    # The guard rides its own cadence (check_interval) so a
                    # large summary_interval cannot delay explosion detection.
                    check_every = 1 if self.debug_nans else max(1, c.check_interval)
                    do_summary = step % c.summary_interval == 0
                    do_check = do_summary or step % check_every == 0
                    if do_check:
                        loss = float(metrics["loss"])  # waits for the card
                        exploded = bool(metrics["loss_exploded"])
                        wall["check"] += time.perf_counter() - t2
                        if exploded:
                            print(f"Loss exploded to {loss:.2f} at step {step}!")
                            out = {"loss": loss, "exploded": True, "step": step}
                            if self.debug_nans:
                                out["nan_report"] = self._locate_nan(pre_step, batch)
                            return out
                    if do_summary:
                        now = time.perf_counter()
                        tput = self._audio_seconds_per_batch * steps_in_window / max(
                            now - t_window, 1e-9
                        )
                        t_window, steps_in_window = now, 0
                        last = {
                            "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "audio_sec_per_sec_per_chip": tput,
                        }
                        self.logger.log_training(
                            loss, step, grad_norm=last["grad_norm"],
                            audio_sec_per_sec_per_chip=tput,
                        )

                    # one process checks its own flag every step; several agree
                    # on theirs at the guard's cadence only
                    if (not several and self._preempt_requested) or (
                        several and do_check and self._preempt_agreed()
                    ):
                        self._checkpoint(False, step, compute_sdr_in_eval, max_eval_items)
                        print(f" > Preempted: checkpointed at step {step}, exiting")
                        # clear the flag so a later fit() on this Trainer
                        # trains instead of instantly re-preempting, and a
                        # fresh SIGTERM gets the graceful path
                        self._preempt_requested = False
                        last.update({"step": step, "preempted": True})
                        return last

                    if step % c.checkpoint_interval == 0:
                        self._checkpoint(True, step, compute_sdr_in_eval, max_eval_items)

                    if max_steps is not None and step >= max_steps:
                        if step % c.checkpoint_interval != 0:
                            # final state off an interval boundary would
                            # otherwise be silently dropped
                            self._checkpoint(False, step, compute_sdr_in_eval, max_eval_items)
                        last["step"] = step
                        return last
            if step > 0 and step % c.checkpoint_interval != 0:
                self._checkpoint(False, step, compute_sdr_in_eval, max_eval_items)
            last["step"] = step
            return last
        finally:
            # a graceful exit (preemption included) must not drop an
            # in-flight checkpoint write
            t0 = time.perf_counter()
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()
            wall["checkpoint"] += time.perf_counter() - t0
            wall["fit"] = time.perf_counter() - t_fit
            for signum, handler in restore_handlers:
                signal.signal(signum, handler)

    def close(self) -> None:
        """Stop the prefetch thread and the loader's threads, and close the
        log files."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        close_loader = getattr(self.train_loader, "close", None)
        if close_loader is not None:
            close_loader()
        self.logger.close()
