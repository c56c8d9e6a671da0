"""setup_s: seconds from the start of the process to the start of the
window (imports, CUDA context, kernel builds, scene and engine set-up,
warm-up). Host clock."""


def read(rec):
    return rec.setup_s
