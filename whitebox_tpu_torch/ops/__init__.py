"""The port's compute path. Counterpart of ``whitebox_tpu/ops``.

- ``dsarith``    : double-single phase arithmetic on torch tensors
                   (``whitebox_tpu/ops/dsarith.py``).
- ``mix_plan``   : host plan of per-(tile, track) slots for the GPU mix
                   (``whitebox_tpu/ops/mix_pallas.py`` plan half).
- ``cuda_build`` : ``nvcc`` build + ctypes binding of ``csrc/*.cu``.
- ``mix_cuda``   : the CUDA mix kernel's wrapper, its plain PyTorch twin and
                   the renderer (``whitebox_tpu/ops/mix_pallas.py`` kernel half).
"""
