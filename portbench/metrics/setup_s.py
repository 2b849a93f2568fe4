"""setup_s: process start to the opening of the window (the kernels'
build or load, the tables built on the card, the warm-up, the senders
connected and their warm-up batches answered)."""


def read(out):
    return out.setup_s
