"""Serving stack of the port: scheduler, steps, engine."""
