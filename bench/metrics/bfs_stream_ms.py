"""bfs_stream_ms: the card's stream time of the window's ``build.bfs_step``
spans over its iterations (every step of the masked BFS, its read of
"changed" included), the card's idle time inside them included: that part
is ``bfs_idle_ms``."""
from bench import spans


def read(run):
    return spans.stream_ms_per_iteration(run, "build.bfs_step")
