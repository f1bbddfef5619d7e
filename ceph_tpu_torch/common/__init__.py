"""Shared helpers of the PyTorch port."""
