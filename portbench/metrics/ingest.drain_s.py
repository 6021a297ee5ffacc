"""ingest.drain_s: the pipeline's `sketch-drain` stage walls (the host
waiting for the device's last signatures after the last file) a Gbase."""


def read(r):
    wall = r.stages.get("sketch-drain") if r.kind == "ingest" else None
    return wall / (r.bases / 1e9) if wall is not None and r.bases else None
