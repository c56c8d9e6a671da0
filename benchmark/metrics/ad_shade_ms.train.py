"""ad_shade_ms.train: host milliseconds an optimiser step in the AD pool's
shade step (the bounce and the deposit of each pool iteration, as the
forward runs it and as the backward recomputes it), from the program's own
span ``rtw.ad.shade`` over the profiled steps: the host's time to launch
its elementwise chain. A program without the span reports nothing."""

from raytracinginoneweekend_tpu_torch.utils import timing

NAME = "rtw.ad.shade"


def read(rec):
    profiled = getattr(timing, "profiled", None)
    if profiled is None or not rec.traced_units:
        return None
    seconds = profiled().seconds().get(NAME, 0.0)
    return seconds / rec.traced_units * 1e3 if seconds > 0 else None
