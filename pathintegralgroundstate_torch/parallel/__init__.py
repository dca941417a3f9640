"""Multi-device runs of the port over torch.distributed: walker (dp) and
partner (tp) sharding (mesh.py), and the sharded dry run (dryrun.py)."""
