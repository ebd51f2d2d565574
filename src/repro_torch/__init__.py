"""PyTorch/CUDA port of the LARK reproduction (``src/repro``).

The package mirrors ``repro``'s layout module for module, so each port
module sits where its reference counterpart does.  It imports ``torch``
and numpy, never ``jax`` and never ``repro``: the numpy-only host code it
needs is copied in.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"`` (see ``repro_torch.device``).  Hand-written
Hopper kernels live in ``repro_torch.kernels``; a kernel wrapper launches
its kernel on a CUDA tensor and runs its plain PyTorch version on a CPU
tensor.
"""
