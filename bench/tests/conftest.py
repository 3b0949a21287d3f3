"""The benchmark's CPU tests import ``bench`` from the repository's root
and the port from ``src``, as ``bench/run.py`` does. Run them with
``python -m pytest bench/tests`` from the root."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

# one thread a worker: the tests run in several workers at once
torch.set_num_threads(1)
