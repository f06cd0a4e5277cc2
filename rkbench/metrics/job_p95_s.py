"""The 95th percentile (linear interpolation between order statistics) of
the host-to-host wall of every job in the window."""

import numpy as np


def read(run):
    if not run.jobs:
        return None
    return float(np.percentile([j.end - j.start for j in run.jobs], 95))
