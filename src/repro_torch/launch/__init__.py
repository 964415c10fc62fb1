"""Launchers of the port: the command lines (``python -m repro_torch.launch.serve``),
the launch tier's specs and steps, and the ranks of a client mesh (``launch.mesh``,
``launch.shards``)."""
