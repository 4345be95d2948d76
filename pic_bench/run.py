"""Run one cell of the benchmark once:

    python3 pic_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``pic_bench/README.md``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from pic_bench import harness

    sys.exit(harness.main(sys.argv[1:]))
