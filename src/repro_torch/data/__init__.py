"""Datasets and the online ring buffer (numpy and torch only)."""
