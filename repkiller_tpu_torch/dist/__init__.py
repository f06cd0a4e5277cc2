"""Drivers beyond one whole-genome program (counterpart of
repkiller_tpu/dist/): the streamed window driver with per-window
checkpoint/resume (windows.py). The sharded backend is not ported yet
(ROADMAP.md section 1 item 14)."""
