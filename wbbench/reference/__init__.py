"""The plain reference: NumPy and SciPy only, from the benchmark's session description.

Nothing here imports ``jax``, ``whitebox_tpu`` or ``whitebox_tpu_torch``; nothing
here reads a table, pool or coefficient that the program made.
"""
