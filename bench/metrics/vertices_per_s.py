"""vertices_per_s: Distribution-Labeling iterations completed over the
window's seconds."""


def read(run):
    w = run.window
    return w["iterations"] / w["seconds"] if w.get("iterations") else None
