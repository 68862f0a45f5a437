"""Serving runtime of the port: policies, scheduler and the Engine."""
