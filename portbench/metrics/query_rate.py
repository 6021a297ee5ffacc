"""query_rate: queries answered in the window over the window's seconds
(each batch ends with its answers on the host as numpy)."""


def read(r):
    return r.answered / r.window_s if r.kind == "search" else None
