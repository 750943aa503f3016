"""Quantization, the OpSet seam and the per-user parallel adapters."""
