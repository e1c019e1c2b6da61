"""Queries served over all of the window's time (the window is whole
chunks of the closed loop; a traced chunk runs after it and is not
counted)."""


def read(rec):
    served = [s for s in rec.served if not s.traced]
    if rec.window_s <= 0 or not served:
        return None
    return len(served) / rec.window_s
