"""repro_torch — the PyTorch/CUDA port of the MultPIM stack.

A second package beside the JAX reference ``repro``: it imports
``torch`` and never ``jax``, and nothing of ``repro`` — it keeps its own
copies of the modules it needs (``core``, ``compiler``, ``obs``). Its
entry points (:func:`repro_torch.engine.get_engine`, the default
:class:`~repro_torch.engine.TorchBackend`) run on a CUDA card unless the
caller asks for the CPU. The crossbar kernels are hand-written CUDA for
Hopper (``csrc/crossbar_step.cu``), built at first use.
"""
