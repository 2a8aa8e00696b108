"""Attention kernels and masks of the port (see flash_attention.py, masks.py)."""
