"""Logical→physical sharding rules (the counterpart of ``repro.sharding``)."""

from repro_torch.sharding.rules import (
    AxisRules,
    DEFAULT_RULES,
    MULTIPOD_RULES,
    axis_rules,
    constrain,
    current_mesh,
    current_rules,
    logical_spec,
    named_sharding,
    to_placements,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "axis_rules",
    "constrain",
    "current_mesh",
    "current_rules",
    "logical_spec",
    "named_sharding",
    "to_placements",
]
