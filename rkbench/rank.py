"""A helper rank of a cell that runs on several cards: rank 0 (``run.py``)
starts one per card past the first and drives it over a control group.

    python3 rkbench/rank.py --rank <i> --world <n> --coordinator <host:port> \
        --device <cuda|cpu> --parent <rank 0's pid>

It prints no result; its errors go to standard error.
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import ranks  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(ranks.helper_main())
