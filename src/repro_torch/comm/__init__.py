"""Fused sync planning and the stacked-replica plan executor."""
