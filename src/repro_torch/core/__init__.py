"""Port of ``repro.core``: succession, scenarios, the analytical model and
the batched §5.1 availability engine.  Import the submodule you need."""
