"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA devices the cell asks for (`chips` in BENCHMARK.json) and
exits non-zero without a result where they are missing. Prints one JSON
object as the last line of standard output, and the checks that decide
`correct`, each with its limit, as the last lines of standard error.
"""

import sys
from pathlib import Path

# the checkout's root: the port's package and this folder's package
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
