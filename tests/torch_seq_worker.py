"""One rank of the port's sequence-parallel tests (`tests/test_torch_sequence_dist.py`).

Joins a gloo process group of CPU ranks through
`voicesplit_tpu_torch.parallel.initialize_distributed`, imports nothing of
JAX, runs `parallel.sequence.separate_long` with the time axis over the
group's ranks and writes its waveform and its shard's `lstm_fwd` calls to
``OUT`` (``.npz``).

Usage: python torch_seq_worker.py RANK WORLD PORT OUT CONFIG WEIGHTS INPUTS
"""

import sys

import numpy as np
import torch

torch.set_num_threads(2)

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out, config_path, weights_path, inputs_path = sys.argv[4:8]

from voicesplit_tpu_torch.config import load_config_from_str  # noqa: E402
from voicesplit_tpu_torch.models.masknet import make_masknet  # noqa: E402
from voicesplit_tpu_torch.ops import lstm_cuda  # noqa: E402
from voicesplit_tpu_torch.parallel import initialize_distributed, separate_long  # noqa: E402

initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
config = load_config_from_str(open(config_path).read())
model = make_masknet(config, device="cpu")
model.load_state_dict(torch.load(weights_path))
inputs = np.load(inputs_path)
calls = []
real = lstm_cuda.lstm_fwd
lstm_cuda.lstm_fwd = lambda *a: calls.append(a[0].shape[0]) or real(*a)
wav = separate_long(config, model, inputs["wav"], inputs["emb"])
np.savez(out, wav=wav, lstm_fwd_frames=np.asarray(calls))
torch.distributed.destroy_process_group()
