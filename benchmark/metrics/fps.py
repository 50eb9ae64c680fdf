"""fps: access units yielded in the window over the window's seconds."""


def read(rec):
    return rec["window_aus"] / rec["window_s"]
