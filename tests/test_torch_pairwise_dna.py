"""Port pairwise DP vs the JAX package on the DNA fixture cases (long
genomic pairs, kept apart from test_torch_pairwise.py so that each file
stays short)."""

import pytest

from test_torch_pairwise import check_fixture_cases


@pytest.mark.parametrize("local", [False, True])
def test_dna_fixture_cases_match_jax(local):
    check_fixture_cases(2, local)
