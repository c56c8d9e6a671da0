"""host_reads.frame: the wavefront engine's reads to the host a frame
(one an epoch and one at the end), counted as the program's own spans
``rtw.wavefront.read`` over the profiled frames. A program without the
span reports nothing."""

from raytracinginoneweekend_tpu_torch.utils import timing

NAME = "rtw.wavefront.read"


def read(rec):
    profiled = getattr(timing, "profiled", None)
    if profiled is None or not rec.traced_units:
        return None
    reads = sum(s.name == NAME for s in profiled().spans)
    return reads / rec.traced_units if reads else None
