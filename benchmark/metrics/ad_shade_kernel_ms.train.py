"""ad_shade_kernel_ms.train: device milliseconds of the AD pool's shade
kernels, forward and adjoint (csrc/ad_shade.cu), an optimiser step, from the
profiler's trace, by kernel name. A program without them reads nothing."""

from benchmark.profiling import device_seconds

NAMES = ("ad_shade_kernel", "ad_shade_grad_kernel")


def read(rec):
    if not rec.trace or not rec.traced_units:
        return None
    seconds = device_seconds(rec.trace, NAMES)
    return seconds / rec.traced_units * 1e3 if seconds > 0 else None
