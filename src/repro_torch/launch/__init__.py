"""repro_torch.launch — command-line entry points of the port.

:mod:`.serve` is the traffic launcher: ``python -m repro_torch.launch.serve
--traffic N`` serves a seeded synthetic trace through the continuous
batcher on the port's engine, on the card by default.
"""
