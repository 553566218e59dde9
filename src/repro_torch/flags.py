"""Feature flags for A/B experiments, a copy of ``repro/flags.py``.

Each flag reads the environment when it is called, as the JAX package
reads it while tracing:

  REPRO_MOE_DENSE=1   use the sort-based dense MoE dispatch instead of
                      the expert-parallel all_to_all
  REPRO_NO_BANDED=1   use masked-dense sliding-window attention instead
                      of the banded O(S*window) path
"""
import os


def moe_dense() -> bool:
    return os.environ.get("REPRO_MOE_DENSE", "") == "1"


def no_banded_attention() -> bool:
    return os.environ.get("REPRO_NO_BANDED", "") == "1"
