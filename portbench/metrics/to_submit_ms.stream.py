"""to_submit_ms: median over the window's batches of the engine's submit
stamp - the ingest tier's first-byte stamp (ring wait, parse, validate)."""

from portbench.readers import record_median_ms


def read(out):
    return record_median_ms(out, 0, 1)
