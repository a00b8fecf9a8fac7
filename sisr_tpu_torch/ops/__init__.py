"""Tensor ops of the port: colour constants, window padding, pixel shuffle."""
