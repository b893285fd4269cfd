"""setup_s: process start to the first timed submit (host clock)."""


def read(r):
    return r.setup_s
