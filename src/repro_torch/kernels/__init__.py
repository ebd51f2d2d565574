"""Port of ``repro.kernels``: the bit-packing math, the hand-written CUDA
kernels that replace the Pallas kernels (the Monte Carlo's ``pac_eval``,
``fused_pac_eval``, ``downtime_eval``, ``node_count``,
``fused_downtime_eval``, ``latency_charge``, and the models'
``mlstm_chunkwise``, ``rglru_scan`` and ``flash_attention_fwd``) and the
§5.2 micro-simulator's tick loop ``microsim_scan``, each beside its plain
PyTorch version, the card-side checks with their planted faults, the
``ops`` dispatch, and the event engine's numpy PAC (``pac_np``)."""
