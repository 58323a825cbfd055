"""Timeline layer: block transport math, event carving, the sample pool,
the NumPy block-sequential parity oracle, and the two sinc forms of
resampled clips (``oversample``: a 4x copy of the samples for the kernel's
polynomial taps; ``prerender``: polyphase products into a pool extension
on the device).

Copies of ``whitebox_tpu/timeline/{transport,pool,carve,carve_native,oracle}.py``
and of the host halves of ``oversample.py`` and ``prerender.py`` with
imports pointed at this package, their device halves in torch ops; the
carve's native walk is built from ``csrc/host`` (``io/native.py``).
"""

from whitebox_tpu_torch.timeline.transport import BlockTransport  # noqa: F401
