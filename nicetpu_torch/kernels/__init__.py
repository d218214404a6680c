"""Kernels and tensor stages of the PyTorch port of the encode path."""
