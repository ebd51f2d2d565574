"""The reference's five examples (``examples/*.py``) on the port, each run
as ``python -m repro_torch.examples.<name> [--device cpu]``: on the card
unless ``--device cpu`` is given (without a card the default raises).
Each keeps the reference's constants and prints its lines, and exposes
``run(...)``, whose defaults are those constants, returning the printed
figures.

* ``quickstart``: the protocol simulator through a leader failover, then
  the reduced smollm trained for 5 steps.
* ``rolling_restart``: every node of a 5-node rf 2 cluster restarted in
  turn, writes committed throughout (host only).
* ``outage_timeseries``: Table 3 row 3 of the §5.2 micro-simulator
  (``microsim_scan`` on the card), the checkpoint stores through an
  outage, and a §5.1 rolling-restart timeline from the batched Monte
  Carlo (``pac_eval`` on the card).
* ``serve_kv``: ``launch.serve`` with a server failure.
* ``train_lm``: ``launch.train`` with a worker failure mid-run.
"""
