"""Port of ``repro.experiments``: frozen specs, the config-driven runner
(availability metric) and provenance-stamped artifacts.

``schema`` is dependency-free, ``spec`` pulls in the engine constants for
validation, and ``runner`` pulls in torch and the engine.  Import the
submodule you need.
"""
