"""Launchers: the LM serving CLI."""
