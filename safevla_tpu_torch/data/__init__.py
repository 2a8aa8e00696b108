"""Data helpers of the port (the task mixtures the evaluation CLI names)."""
