"""Fused sync planning, the collectives, and the plan executors (stacked
and per rank)."""
