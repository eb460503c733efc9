"""Numerical guards for the training sweeps and the fold-in, and the
fold-in's pre-swap quality gates."""
