"""The port's auditor: the JAX package's static invariant auditor,
retargeted to PyTorch and the H100.

Five passes prove the serving stack's execution contract from source
ASTs, from each serving entry point run once under a dispatch recorder,
and (on a card) from the build:

  * :mod:`repro_torch.analysis.sync`: one device read per step-loop
    phase, no hidden host<->device synchronisation (RWA1xx);
  * :mod:`repro_torch.analysis.donation`: the caches updated in place
    (RWA2xx);
  * :mod:`repro_torch.analysis.compile_bound`: the reachable
    shape-signature set against the documented bound, and operands that
    would pay a host copy each call (RWA3xx);
  * :mod:`repro_torch.analysis.smem`: every kernel's shared memory and
    registers against the H100's budget and ``plan_matmul``'s
    accounting (RWA4xx);
  * :mod:`repro_torch.analysis.rules`: PagePool transaction discipline
    and serving-path hygiene (RWA5xx).

:mod:`repro_torch.analysis.dispatch` is the recorder the run-time
checks read. CLI: ``python -m repro_torch.analysis.audit``.
"""
from repro_torch.analysis.dispatch import (Recorder, count_op,
                                           min_weight_bytes,
                                           run_entry_points, weight_concat)
from repro_torch.analysis.report import CODES, Diagnostic, PassResult

__all__ = [
    "CODES", "Diagnostic", "PassResult", "Recorder", "count_op",
    "min_weight_bytes", "run_entry_points", "weight_concat",
]
