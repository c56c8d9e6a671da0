"""step_s: the window's seconds over the optimiser steps it completed (a
step is complete when its loss is on the host). Host clock."""


def read(rec):
    if "steps" not in rec.work or not rec.units:
        return None
    return rec.window_s / rec.units
