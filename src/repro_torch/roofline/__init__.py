"""Roofline counts and model for the H100 (see ``model.py``)."""
