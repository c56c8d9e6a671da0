"""ad_recompute_ms.train: host milliseconds an optimiser step of the AD
pool's epochs run again by the backward (the checkpoint's recompute),
from the program's own span ``rtw.ad.recompute`` over the profiled steps.
A program without the span reports nothing."""

from raytracinginoneweekend_tpu_torch.utils import timing

NAME = "rtw.ad.recompute"


def read(rec):
    profiled = getattr(timing, "profiled", None)
    if profiled is None or not rec.traced_units:
        return None
    seconds = profiled().seconds().get(NAME, 0.0)
    return seconds / rec.traced_units * 1e3 if seconds > 0 else None
