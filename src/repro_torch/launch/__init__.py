"""repro_torch.launch — command-line entry points of the port.

:mod:`.serve` is the serving launcher: ``python -m repro_torch.launch.serve
--arch gemma2-9b --pim --pim-scope full`` prefills and greedily decodes a
model zoo architecture, and ``--traffic N`` serves a seeded synthetic
trace through the continuous batcher. :mod:`.train` is the training
launcher: ``python -m repro_torch.launch.train --arch qwen3-8b`` trains
with AdamW, microbatching and remat, checkpointing through the retrying
runner under ``--ckpt-dir``. Both run on the port's engine, on the card
by default; :mod:`.mesh` builds the host's device mesh and the
production meshes. :mod:`.dryrun` is the multi-pod dry-run: ``python -m
repro_torch.launch.dryrun --all --both-meshes`` gives each (arch x shape)
cell's per-device bytes and FLOPs on the 16 x 16 and 2 x 16 x 16 meshes
from the partition specs and a fake-tensor trace, against the card's
memory.
"""
