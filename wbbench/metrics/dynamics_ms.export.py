"""Device time of the fused dynamics kernel per traced export, in ms
(``torch.profiler``): the kernels named ``dyn_kernel``
(``whitebox_tpu_torch/csrc/dynamics_scan.cu``); nothing to read where the
trace holds none."""

#: the kernel's name in the trace
KERNEL = "dyn_kernel"


def read(run):
    if run.trace is None or not run.traced:
        return None
    seconds = run.trace.op_seconds(lambda name: KERNEL in name)
    return seconds / len(run.traced) * 1e3 if seconds > 0 else None
