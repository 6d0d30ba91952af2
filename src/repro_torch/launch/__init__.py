"""repro_torch.launch — command-line entry points of the port.

:mod:`.serve` is the serving launcher: ``python -m repro_torch.launch.serve
--arch gemma2-9b --pim --pim-scope full`` prefills and greedily decodes a
model zoo architecture, and ``--traffic N`` serves a seeded synthetic
trace through the continuous batcher; both on the port's engine, on the
card by default.
"""
