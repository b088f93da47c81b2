"""Compression core: bucketed top-k, QSGD and the sync configuration."""
