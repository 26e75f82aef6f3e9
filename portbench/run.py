"""The port's benchmark: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  See
``portbench/harness.py``."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# every build and kernel cache of the program at a fixed path in the checkout
os.environ["SD_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
