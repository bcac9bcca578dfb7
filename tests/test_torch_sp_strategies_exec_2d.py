"""TokenRing2D and the multi-pod hybrid on the virtual ring's pod and inner
views, held against the JAX functions under nested ``jax.vmap`` (the checks
and their tolerances are ``test_torch_sp_strategies_exec.check_case``'s)."""

import pytest
from test_torch_sp_strategies_exec import CASES, _few_threads, check_case  # noqa: F401

TWO_AXIS = [c for c in CASES if c.pods > 1]


@pytest.mark.parametrize("case", TWO_AXIS, ids=[c.id for c in TWO_AXIS])
def test_strategy_matches_the_jax_function(case):
    check_case(case)
