"""shade_regen_ms.frame: device milliseconds of the shade + regen kernels
(kernel 2) a frame, from the profiler's trace, by kernel name. Pointing it
at other kernels is a change of the benchmark."""

from benchmark.profiling import device_seconds

NAMES = ("shade_regen_kernel",)


def read(rec):
    if not rec.trace or not rec.traced_units:
        return None
    seconds = device_seconds(rec.trace, NAMES)
    return seconds / rec.traced_units * 1e3 if seconds > 0 else None
