"""The port's successive halving against the JAX package's ``run_sha``
for the transformer families (FT-Transformer and single-record BERT at
token_dim 16, depth 1, 2 heads), as ``test_torch_sha.py`` holds the
others: the same plan, seams and tolerances."""

import pytest
import torch

from test_torch_sha import check_sha_against_jax
from torch_hpo_seams import split
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return split()


@pytest.mark.parametrize("name,ema", [("ft_transformer", 0.9), ("bert", 0.0)])
def test_successive_halving_matches_the_jax_sweep(data, name, ema):
    check_sha_against_jax(data, name, ema)
