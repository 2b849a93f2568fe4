"""service_ms: median over the window's batches of the engine's done stamp
- its submit stamp (copies in, the forward, the readback)."""

from portbench.readers import record_median_ms


def read(out):
    return record_median_ms(out, 1, 2)
