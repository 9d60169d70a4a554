"""Sharding plans over a mesh of gloo ranks (``specs``) and one rank's
shards under a plan (``placement``)."""
from repro_torch.sharding.specs import (ShardingPlan, batch_shardings,
                                        cache_shardings, make_plan,
                                        opt_state_shardings, param_shardings)

__all__ = ["ShardingPlan", "make_plan", "param_shardings", "batch_shardings",
           "cache_shardings", "opt_state_shardings"]
