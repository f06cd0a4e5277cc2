"""Drivers beyond one whole-genome program (counterpart of
repkiller_tpu/dist/): the streamed window driver with per-window
checkpoint/resume (windows.py), and the sharded backend over a (data,
shard) mesh (mesh.py, sharded.py, with index/shards.py) and its
cross-process output helpers (merge.py)."""
