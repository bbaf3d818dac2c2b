"""PyTorch/CUDA port of the ELK reproduction, beside the JAX package.

``repro`` (JAX, TPU) is the reference and is never imported from here;
this package imports ``torch`` only.  Entry points default to
``device="cuda"`` and raise when no card is present; the CPU is used only
when a caller asks for it, as the parity tests do.
"""
