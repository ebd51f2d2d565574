"""Port of ``repro.launch``: the serving driver."""
