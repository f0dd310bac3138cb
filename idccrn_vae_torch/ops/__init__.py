"""Tensor ops of the port (cpack layouts, torch weight layouts)."""
