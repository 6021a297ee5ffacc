"""ingest_rate: the bases of every completed pass over the seconds from the
window's start to the end of its last pass."""


def read(r):
    return r.bases / 1e6 / r.window_s if r.kind == "ingest" and r.bases else None
