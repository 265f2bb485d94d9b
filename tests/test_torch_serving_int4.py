"""The serving scenarios of ``tests/test_serving.py`` on the packed-int4 split-flat KV cache:
the port's engine and cluster give the JAX package's greedy tokens, request
by request (``serving_scenarios.py``; the other caches and the rest of the
serving tests are in the sibling files and ``test_torch_serving.py``)."""

from serving_scenarios import scenario_tests
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax_side, port_model, test_scenario_matches_jax = scenario_tests('int4_smajor')
