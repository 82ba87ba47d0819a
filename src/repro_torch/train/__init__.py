"""Durable state: the port's checkpoint layout (:mod:`.checkpoint`)."""
