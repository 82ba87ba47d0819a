"""Launchers: the LM serving and training CLIs."""
