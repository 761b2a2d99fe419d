"""PyTorch / CUDA port of the AsterixDB reproduction (``repro``).

The package keeps the reference's layout and module names.  It runs on
one NVIDIA H100 with hand-written CUDA kernels (``kernels/csrc``): the
columnar query path's per-operator kernels (rung 2: K1-K4), the fused
index chain A6 behind the plan cache (rung 3, ``columnar/plancache``),
the partition runtime's stacked launches over ``n`` partition lanes of
the card (rung 4, ``runtime/spmd``: ``run_query(..., mesh=n)``), the
fuzzy kernels (K5, K6, A7), the model serving kernels (K7-K9) and the
training path's backward kernels (K7's and K8's).
Operands live on the CUDA device unless the caller asks for the CPU::

    import repro_torch
    repro_torch.set_device("cpu")      # the kernels' plain versions

With the default ``"cuda"`` and no card present, the first kernel call
raises ``RuntimeError``; nothing falls back to the CPU quietly.
"""

from .kernels.ops import device, set_device

__all__ = ["device", "set_device"]
