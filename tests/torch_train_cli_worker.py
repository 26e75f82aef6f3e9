"""One rank of the trainer CLI under a launcher's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT set by the caller), for
tests/test_torch_train_cli.py.

    python tests/torch_train_cli_worker.py OUT ARGV...

Runs ``train_lora_dreambooth_torch.main(ARGV)`` on one torch thread, with
TensorBoard's writer stubbed (its import loads TensorFlow) and the
checkpoints it saves and the writers it opens recorded, and saves
``{"state", "saved", "writers"}`` to OUT with ``torch.save``.  It imports
no JAX.
"""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import train_lora_dreambooth_torch as cli  # noqa: E402
from stable_diffusion_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


def main(out: str, argv) -> None:
    torch.set_num_threads(1)
    saved, writers = [], []

    class Writer:
        def __init__(self, log_dir):
            writers.append(log_dir)

        def add_scalars(self, *args):
            pass

        def close(self):
            pass

    sys.modules["torch.utils.tensorboard"] = types.SimpleNamespace(SummaryWriter=Writer)
    save = ckpt.save_train_checkpoint

    def recorded(path, tree):
        saved.append(path)
        return save(path, tree)

    ckpt.save_train_checkpoint = recorded
    state = cli.main(argv)
    torch.save({"state": state, "saved": saved, "writers": writers}, out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
