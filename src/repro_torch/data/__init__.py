"""Radar data synthesis and federated partitioning."""
