"""Entry point of the benchmark of hairfastgan_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The compile caches of the run are fixed
directories inside the checkout (portbench/.cache/), set before torch is
imported; the port builds its own kernel into hairfastgan_torch/_build/.
See portbench/harness.py for what a run does and prints.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# the package's root, in place of this script's folder (whose trace.py would shadow the stdlib's)
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
