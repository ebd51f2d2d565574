"""Port of ``repro.kernels``: the bit-packing math, the hand-written CUDA
kernels that replace the Pallas ``pac_eval`` and ``fused_pac_eval``
kernels (each beside its plain PyTorch version), and the ``step_eval``
dispatch."""
