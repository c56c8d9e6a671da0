"""backward_ms.train: milliseconds of the fit step's ``loss.backward()``
(ending in a synchronise), a span of the benchmark's own code, averaged
over the traced steps."""


def read(rec):
    s = rec.spans.get("backward")
    return sum(s) / len(s) * 1e3 if s else None
