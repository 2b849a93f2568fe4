"""The benchmark of the PyTorch and CUDA port (``fleetrec_tpu_torch``):
its served path under the cells of ``BENCHMARK.json``.  ``run.py`` is the
entry; see ``README.md``."""
