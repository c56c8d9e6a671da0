"""previews_per_s: previews answered in the window over the window's
seconds (from the first due time to the last answer): above the server's
knee the queue never empties, so this is the rate the server sustains.
Host clock."""


def read(rec):
    done = rec.work.get("previews")
    if not done or not rec.window_s > 0:
        return None
    return done / rec.window_s
