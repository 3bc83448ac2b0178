"""The yardstick: published peaks, and operations and bytes computed from a
configuration's shapes (what the work requires, whatever implements it)."""
