"""closest_hit_ms.train: device milliseconds of the closest-hit kernels (kernel
1) an optimiser step, from the profiler's trace, by kernel name. Pointing it
at other kernels is a change of the benchmark."""

from benchmark.profiling import device_seconds

NAMES = ("closest_hit_kernel",)


def read(rec):
    if not rec.trace or not rec.traced_units:
        return None
    seconds = device_seconds(rec.trace, NAMES)
    return seconds / rec.traced_units * 1e3 if seconds > 0 else None
