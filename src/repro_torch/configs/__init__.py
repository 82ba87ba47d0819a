"""System presets on the port's own ``TMConfig``."""
