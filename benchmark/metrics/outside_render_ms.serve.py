"""outside_render_ms.serve: the mean over answered requests of (the
server's time in its handler - its own ``seconds`` for the render), in
milliseconds: the colour quantisation, the copy to the host and the PNG
encode. Both are taken in the server's process, so the queue in front of
it is not counted. Host clock."""


def read(rec):
    d = [r["handle_s"] - r["seconds"] for r in rec.responses
         if "handle_s" in r]
    return sum(d) / len(d) * 1e3 if d else None
