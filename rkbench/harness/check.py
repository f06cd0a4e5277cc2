"""The comparison that decides ``correct``: every checked job's fragment
table and family labels, and every file it wrote, against the plain
reference's, exactly.

Each number compared counts differences, so a sound run reads 0 and the
limit of each is 0: the outputs are integers and bytes, and the program
states that they are deterministic and equal to its reference semantics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

TABLE = ("xStart", "yStart", "xEnd", "yEnd", "strand", "length", "score",
         "idents")
LIMITS = {"failed_jobs": 0, "fragment_rows_differing": 0,
          "family_labels_differing": 0, "file_lines_differing": 0}


def rows_differing(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                   fields) -> int:
    """Rows where any of ``fields`` differ, over the common length, plus
    the rows one table has beyond the other."""
    n, m = got["xStart"].shape[0], want["xStart"].shape[0]
    c = min(n, m)
    bad = np.zeros(c, bool)
    for f in fields:
        bad |= np.asarray(got[f][:c]) != np.asarray(want[f][:c])
    return int(bad.sum()) + abs(n - m)


def lines_differing(got: bytes, want: bytes) -> int:
    """Lines that differ, position by position, plus the lines one file has
    beyond the other."""
    if got == want:
        return 0
    a, b = got.split(b"\n"), want.split(b"\n")
    c = min(len(a), len(b))
    return sum(1 for x, y in zip(a[:c], b[:c]) if x != y) + abs(len(a) - len(b))


def compare(tables: List[Dict[str, np.ndarray]], files: List[Dict[str, bytes]],
            want_table: Dict[str, np.ndarray], want_files: Dict[str, bytes]):
    """Tables of jobs and files of jobs on one genome against the
    reference's -> the counts of differences."""
    out = {"fragment_rows_differing": 0, "family_labels_differing": 0,
           "file_lines_differing": 0}
    for t in tables:
        out["fragment_rows_differing"] += rows_differing(t, want_table, TABLE)
        out["family_labels_differing"] += rows_differing(t, want_table,
                                                         ("group",))
    for fs in files:
        for name, want in want_files.items():
            got = fs.get(name)
            out["file_lines_differing"] += (
                want.count(b"\n") + 1 if got is None
                else lines_differing(got, want))
    return out


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
