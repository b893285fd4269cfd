"""Run one cell of the port's benchmark once and print its result line.

    python3 cnibench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program (``src/repro_torch``) and the
harness (``cnibench/cnib``) are put on the path here, so the caller sets
no environment.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

from cnib.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
