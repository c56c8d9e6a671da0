"""render_ms_p50.serve: the median of the render server's own
``seconds`` (its host clock around the synchronised render) over the
window's answered requests, in milliseconds."""


def read(rec):
    s = sorted(r["seconds"] for r in rec.responses if "seconds" in r)
    if not s:
        return None
    mid = len(s) // 2
    return (s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])) * 1e3
