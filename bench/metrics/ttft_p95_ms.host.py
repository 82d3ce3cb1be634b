"""``ttft_p95_ms`` in a cell whose card is idle most of its traced stretch:
there the host paces the first tokens, so the same reading is a measure of
the host, kept beside the cell's throughput and not bounded."""
from bench import spec


def read(run):
    return spec.reader("ttft_p95_ms")(run)
