"""One run of one benchmark cell:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output and each number
compared, beside its limit, as the last lines of standard error. Exits
with 2, printing no result, where there is no CUDA card or too few, or a
file the cell needs is missing."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

if __name__ == "__main__":
    from bench.harness import main
    sys.exit(main())
