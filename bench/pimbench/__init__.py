"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

Everything here is the benchmark's own yardstick: configurations read
from JSON, weights and prompts drawn from the run's seed, the closed
loop of batch jobs that drives the port's serving entry points, the
reading of the profiler trace, the work counts and peaks, and the
comparison with the plain reference in ``bench/reference``. The port
supplies only the system under test. Nothing here imports JAX or the
JAX package ``repro``.
"""
