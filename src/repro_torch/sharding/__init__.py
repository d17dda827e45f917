"""Logical-axis sharding rules and the placement trees built from them,
the reference's ``sharding`` package on ``torch.distributed.tensor``."""
from .axis_rules import (DECODE_RULES, LONG_DECODE_RULES, TRAIN_RULES,
                         AxisRules, current_rules, divisible_spec, full,
                         is_dtensor, logical_spec, placements, replicate,
                         set_rules, with_logical_constraint)

__all__ = ["AxisRules", "current_rules", "divisible_spec", "full",
           "is_dtensor", "logical_spec", "placements", "replicate",
           "set_rules", "with_logical_constraint",
           "TRAIN_RULES", "DECODE_RULES", "LONG_DECODE_RULES"]
