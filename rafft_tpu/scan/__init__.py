"""Stem-detection scan: encodings, FFT cross-correlation, window-slide.

Design notes: the JAX paths (correlate.py/windows.py jax
functions) operate on fixed-shape padded batches; the numpy paths mirror
the reference's float semantics bit-for-bit for the parity engine
(/root/reference/rafft/utils.py:70-132, rafft.py:36-83).
"""
