"""The port's data and tensor parallelism on the card (``gpu``: skips
without one; no JAX, so it runs with ``--noconftest`` where JAX is absent).
The CPU tests of the same code are ``tests/test_torch_parallel.py``."""

import pytest
import torch

from repurpose_tpu_torch.parallel import mesh as pmesh
from repurpose_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.mark.gpu
def test_dryrun_with_two_ranks_sharing_the_card():
    """dp x tp on the card (model=2: the attention kernels at 4 of 8 heads,
    float32: the first designs), two ranks sharing it over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    msg = dryrun_multichip(2, "cuda", share_card=True)
    assert "'model': 2" in msg, msg


@pytest.mark.gpu
def test_more_ranks_than_cards_raise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="share_card"):
        pmesh.rank_device("cuda", 0, cards + 1, "nccl", share_card=False)
    assert pmesh.rank_device("cuda", cards, cards + 1, "gloo", share_card=True).index == 0
