"""PyTorch / CUDA port of the AsterixDB reproduction (``repro``).

The package keeps the reference's layout and module names; its columnar
query path runs on one NVIDIA H100 with hand-written CUDA kernels for the
four Pallas kernels of rung 2 (``kernels/csrc``).  Operands live on the
CUDA device unless the caller asks for the CPU::

    import repro_torch
    repro_torch.set_device("cpu")      # the kernels' plain versions

With the default ``"cuda"`` and no card present, the first kernel call
raises ``RuntimeError``; nothing falls back to the CPU quietly.
"""

from .kernels.ops import device, set_device

__all__ = ["device", "set_device"]
