"""setup_s: seconds from the harness's start to the window's, on the host
clock: import, kernel and parser builds (cached in the checkout after a
cell's first run), inputs drawn, index built, warm-up."""


def read(r):
    return r.setup_s
