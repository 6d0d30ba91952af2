"""repro_torch.faults — deterministic device-error layer for the PIM stack.

The port's copy of ``repro.faults``: the same models, masks, residue
checks and retry policy, so both packages inject bit-identical faults
for the same key.

Three pieces, mirroring the reliability loop end to end:

* **Injection** (:mod:`.model`, :mod:`.inject`) — seeded
  :class:`FaultModel` (stuck-at cell maps, transient per-gate bit
  flips, epoch-indexed drift) applied as bitwise masks on the packed
  words inside every backend, selected via the backend spec
  (``"torch:pack=true,faults=flip@1e-5@7"``). ``faults=none`` resolves to
  no model and stays bit-identical to a fault-free build.
* **Detection** (:mod:`.detect` + the compiled
  :func:`repro_torch.core.residue.residue_program` family) — mod-3/mod-7
  residues computed on-device beside the MAC chain, checked at
  ``drain()`` against a host :class:`ResidueShadow`, plus the exact
  drained-token checksum at the host boundary.
* **Recovery** (:mod:`.policy`) — one :class:`RetryPolicy` shared by
  the resident executor's bounded replay-with-fresh-restart, the serve
  batcher's round-trip restarts, and the train loop's
  checkpoint-restore retries; persistent failures escalate to lane
  quarantine and coordinate blocklisting
  (:class:`repro_torch.device.config.CoordAllocator`).
"""
from .detect import ResidueShadow, decode_residues
from .inject import (apply_stuck, numpy_kernel_packed_faulty,
                     pass_fault_tensors)
from .model import (FaultModel, fault_model_names, get_fault_model,
                    register_fault_model)
from .policy import DEFAULT_POLICY, RetryPolicy

__all__ = [
    "FaultModel", "register_fault_model", "get_fault_model",
    "fault_model_names",
    "pass_fault_tensors", "apply_stuck", "numpy_kernel_packed_faulty",
    "ResidueShadow", "decode_residues",
    "RetryPolicy", "DEFAULT_POLICY",
]
