"""The port's counterparts of the reference's benchmark tools, as modules
of the package (``python -m repro_torch.tools.<name>``):

* ``kernel_bench`` — µs per ``step_eval`` call in both layouts on the
  card, the traffic model's ``kernel_step_hbm_*`` rows, and with
  ``--autotune`` both tile races;
* ``roofline`` — roofline terms of the dry run's records at the H100's
  peaks, and the Monte Carlo step's traffic in both layouts;
* ``heartbeat_crossover`` — the §4.1 control-plane crossover (stdlib);
* ``make_experiments_md`` — an EXPERIMENTS document from the dry run's
  records, written where the command line says.
"""
