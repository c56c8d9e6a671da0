"""engine_setup_ms.frame: host milliseconds a frame of the wavefront
engine's set-up, from the program's own spans: ``rtw.wavefront.build``
(the engine, the ledger and the prologue) and ``rtw.wavefront.capture``
(the epoch's CUDA graph), summed over the profiled frames and divided by
them. A program without these spans reports nothing."""

from raytracinginoneweekend_tpu_torch.utils import timing

NAMES = ("rtw.wavefront.build", "rtw.wavefront.capture")


def read(rec):
    profiled = getattr(timing, "profiled", None)
    if profiled is None or not rec.traced_units:
        return None
    seconds = profiled().seconds()
    total = sum(seconds.get(n, 0.0) for n in NAMES)
    return total / rec.traced_units * 1e3 if total > 0 else None
