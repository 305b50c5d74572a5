"""The wide variant's train-mode `MaskNet` on the fused conv chain
(`VOICESPLIT_FUSED_CHAIN=1`) against the JAX package's, with one and two
extra dilated blocks as chain layers: the slowest of the wide comparisons
(the JAX chain in interpret mode at 70 frames), in a file of its own so
that test workers that take whole files share them out.  Inputs, weights
and tolerances are `tests/test_torch_wide.py`'s."""

import pytest
import torch

from test_torch_wide import check_train_route


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads for this file's tests (several test processes
    share one machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n", [1, 2])
def test_wide_masknet_train_matches_jax_on_the_fused_chain(n, monkeypatch):
    check_train_route("fused_chain", n, monkeypatch)
