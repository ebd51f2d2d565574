"""Port of ``repro.kernels``: the bit-packing math, the hand-written CUDA
kernels that replace the Pallas kernels (the Monte Carlo's ``pac_eval``,
``fused_pac_eval``, ``downtime_eval``, ``node_count``,
``fused_downtime_eval``, ``latency_charge``, and the models'
``mlstm_chunkwise``, ``rglru_scan`` and ``flash_attention_fwd``), each
beside its plain PyTorch version, the card-side checks with their
planted faults, and the ``ops`` dispatch."""
