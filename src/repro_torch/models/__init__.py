"""Transformer layers and the pattern-driven backbone."""
