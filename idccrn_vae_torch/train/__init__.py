"""Checkpoints of the port (the trainers are not ported yet)."""
