"""occupancy.frame: the wavefront engine's own counters over the traced
frames: segments traced / (iterations x lanes)."""


def read(rec):
    lane_iters = rec.counters.get("lane_iters")
    if not lane_iters:
        return None
    return rec.counters["segments"] / lane_iters
