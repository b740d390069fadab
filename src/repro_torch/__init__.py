"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The port mirrors ``repro``'s module layout (``repro_torch.core.engine`` is
the counterpart of ``repro.core.engine``) and imports nothing from it.  Its
entry points run on the card by default and raise when no CUDA device is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels instead.
"""
