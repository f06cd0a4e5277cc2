"""The benchmark's own code: the job, its spans, the trace reduction, the
roofline arithmetic, the plain reference and the comparison that decides
``correct``. Nothing here is part of the program under test."""
