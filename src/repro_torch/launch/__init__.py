"""Port of ``repro.launch``: the serve and train drivers, process groups
and meshes across ranks, the sharding specs, and the dry run with its
step analysis."""
