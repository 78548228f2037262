"""``uploads_per_s``: uploads answered with a ranked list per second: the
replies that came back inside the window, over the time from the window's
start to the last of them (the window's work and time, without a partial
batch at its close)."""


def read(rec):
    n, t = rec.get("completed_in_window"), rec.get("last_completion_s")
    if not n or not t:
        return None
    return n / t
