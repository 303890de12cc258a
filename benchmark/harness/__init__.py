"""The benchmark harness of the PyTorch and CUDA port (``benchmark/run.py``).

Modules: :mod:`.spec` finds a cell's files by name, :mod:`.traffic` is the
one generator that reads every traffic mix, :mod:`.cell` runs a cell once,
:mod:`.trace` reduces a profiler trace to busy time, kernel times and idle
gaps, and :mod:`.roofline` holds the card's peaks and the kernels' work
functions.  Nothing here imports JAX or the JAX package.
"""
