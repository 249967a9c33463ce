"""TinyTrain serving on PyTorch and CUDA: the port of ``repro`` to NVIDIA
Hopper.  Mirrors ``repro``'s module layout; imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``."""
