"""The sharding rules: logical axes to mesh axes, and DTensor placements."""

from repro_torch.sharding.rules import (
    LONG_SERVE_RULES,
    Rules,
    SERVE_RULES,
    TRAIN_RULES,
    constrain,
    place_tree,
    placements_for,
    rules_for,
    sharding_for,
    spec_for,
    tree_shardings,
)

__all__ = [
    "LONG_SERVE_RULES",
    "Rules",
    "SERVE_RULES",
    "TRAIN_RULES",
    "constrain",
    "place_tree",
    "placements_for",
    "rules_for",
    "sharding_for",
    "spec_for",
    "tree_shardings",
]
