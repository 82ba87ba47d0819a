"""Distributed-optimization tricks that run on one device (gradient
compression). The reference's meshes and collectives wait for ROADMAP
queue 1 item 6."""
