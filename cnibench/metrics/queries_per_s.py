"""queries_per_s: queries returned inside the window over its length."""


def read(r):
    return len(r.completed) / r.window_s
