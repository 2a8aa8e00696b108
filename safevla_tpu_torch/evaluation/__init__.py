"""Serving entry point of the port: the batched inference agent."""
