"""Evaluation engines."""
