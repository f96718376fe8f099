"""Eager ops and the hand-written Hopper kernels with their plain versions."""
