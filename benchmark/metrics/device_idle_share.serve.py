"""device_idle_share: 1 - (union of the device's kernel, copy and memset
intervals) / the traced window, from the profiler's timeline."""


def read(rec):
    if not rec.trace or not rec.trace["busy_s"] > 0:
        return None
    return 1.0 - rec.trace["busy_s"] / rec.trace["window_s"]
