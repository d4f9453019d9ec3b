"""bfs_steps_per_iteration: the window's ``build.bfs_step`` spans over its
iterations (both passes, each with the step that finds no change)."""
from bench import spans


def read(run):
    n = spans.iterations(run)
    if n is None:
        return None
    return sum(ev["name"] == "build.bfs_step" for ev in run.spans) / n
