"""ingest.parse_s: the pipeline's `parse` stage walls (StageTimer, summed
over its parse threads and the window's passes) a Gbase ingested."""


def read(r):
    wall = r.stages.get("parse") if r.kind == "ingest" else None
    return wall / (r.bases / 1e9) if wall is not None and r.bases else None
