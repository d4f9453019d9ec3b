"""prune_stream_ms: the card's stream time of the window's ``build.prune``
spans over its iterations (the prune test: ``vi``'s row, the membership
table, the gather and ``any`` over the n x L state), the card's idle time
inside them included."""
from bench import spans


def read(run):
    return spans.stream_ms_per_iteration(run, "build.prune")
