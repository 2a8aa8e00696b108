"""Rollout collection: the environment pool and the sync rollout runner."""
