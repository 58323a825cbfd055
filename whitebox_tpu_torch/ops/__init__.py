"""The port's compute path. Counterpart of ``whitebox_tpu/ops``.

- ``automation`` : automation lanes: the data model, the host packers, the
                   plain PyTorch lane sweep and pan law
                   (``whitebox_tpu/ops/automation.py``).
- ``dsarith``    : double-single phase arithmetic on torch tensors
                   (``whitebox_tpu/ops/dsarith.py``).
- ``mix_plan``   : host plan of per-(tile, track) slots for the GPU mix
                   (``whitebox_tpu/ops/mix_pallas.py`` plan half).
- ``cuda_build`` : ``nvcc`` build + ctypes binding of ``csrc/*.cu``.
- ``mix_cuda``   : the CUDA mix kernel's wrappers (with and without lanes),
                   their plain PyTorch twins and the renderer
                   (``whitebox_tpu/ops/mix_pallas.py`` kernel half).
"""
