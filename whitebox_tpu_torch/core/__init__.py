"""Core layer: beat/sample math, PCM formats, panning laws, tempo and meter
maps, buffer conversions.

Copies of the JAX package's ``whitebox_tpu/core`` modules of the same names
(they hold no JAX), with imports pointed at this package, so the port
stands alone.
"""
