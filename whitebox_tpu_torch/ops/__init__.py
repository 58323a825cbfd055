"""The port's compute path. Counterpart of ``whitebox_tpu/ops``.

- ``automation`` : automation lanes: the data model, the host packers, the
                   plain PyTorch lane sweep and pan law
                   (``whitebox_tpu/ops/automation.py``).
- ``biquad``     : RBJ biquad design, eigenbasis section params and chain
                   packing (host), the f32 prefix-scan filter
                   (``whitebox_tpu/ops/biquad.py``, its LTI half).
- ``biquad_cuda``: the effect finisher's biquad cascade: the hand CUDA
                   kernel's wrapper, its plain twin (the per-section scan)
                   and the host model of its blocked recurrence.
- ``scan_util``  : Hillis-Steele inclusive prefix scan on torch tensors.
- ``dsarith``    : double-single phase arithmetic on torch tensors
                   (``whitebox_tpu/ops/dsarith.py``).
- ``resample``   : windowed-sinc design tables (phase bank, rational
                   operator, Taylor derivative rows, LS polynomial taps)
                   and ``resample_audio`` in torch ops
                   (``whitebox_tpu/ops/resample.py``).
- ``mix_plan``   : host plan of per-(tile, track) slots for the GPU mix
                   (``whitebox_tpu/ops/mix_pallas.py`` plan half).
- ``cuda_build`` : ``nvcc`` build + ctypes binding of ``csrc/*.cu``.
- ``mix_cuda``   : the CUDA mix kernel's wrappers (with and without lanes,
                   per track; linear, Catmull-Rom and polynomial-tap
                   resampling), their plain PyTorch twins and the renderer
                   (``whitebox_tpu/ops/mix_pallas.py`` kernel half).
"""
