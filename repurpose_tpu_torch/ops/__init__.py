"""Tensor ops of the port: attention, decode and Soft-NMS."""
