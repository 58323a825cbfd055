"""Timeline layer: block transport math, event carving, the sample pool and
the NumPy block-sequential parity oracle.

Copies of ``whitebox_tpu/timeline/{transport,pool,carve,carve_native,oracle}.py``
with imports pointed at this package; the carve's native walk is built from
``csrc/host`` (``io/native.py``).
"""

from whitebox_tpu_torch.timeline.transport import BlockTransport  # noqa: F401
