"""PyTorch + CUDA port of the TokenRing reproduction (``repro``).

Module names mirror the JAX package so each counterpart is easy to find:
``repro_torch.kernels.ops`` is ``repro.kernels.ops``, and so on.  The port
imports ``torch`` and numpy only; it never imports ``jax`` or ``repro``.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
