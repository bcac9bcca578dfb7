"""The ring executor on the virtual ring against the JAX executor: the
Ring-Attention baselines and TokenRing's faithful schedule (the checks and
their tolerances are ``test_torch_ring_exec.check_ring_case``'s)."""

import pytest
from test_torch_ring_exec import _few_threads, case_id, cases, check_ring_case  # noqa: F401

CASES = cases(("tokenring_faithful", "ring", "ring_bidir"))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_ring_matches_the_jax_executor(case):
    check_ring_case(case)
