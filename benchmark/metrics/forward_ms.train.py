"""forward_ms.train: milliseconds of the fit step's forward call
(``optim.inverse.render_loss``, ending in a synchronise), a span of the
benchmark's own code, averaged over the traced steps."""


def read(rec):
    s = rec.spans.get("forward")
    return sum(s) / len(s) * 1e3 if s else None
