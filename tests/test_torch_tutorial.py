"""The port's walkthrough (``python -m transformergrooveinfilling_tpu_torch.
tutorial``), the counterpart of the repository's root ``tutorial.py``: run on
the CPU in a child process where ``import jax`` fails, as on the machine with
the card, it goes through its eight steps to the end."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a None in sys.modules makes ``import name`` raise ImportError, as an absent
# package does
RUN_WITHOUT_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pandas", "tqdm", "yaml"):
    sys.modules[name] = None
import runpy
sys.argv = ["tutorial", "--device", "cpu"]
runpy.run_module("transformergrooveinfilling_tpu_torch.tutorial", run_name="__main__",
                 alter_sys=True)
"""


def test_tutorial_runs_its_eight_steps_on_the_cpu():
    proc = subprocess.run([sys.executable, "-c", RUN_WITHOUT_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert re.findall(r"^\[(\d)\]", out, flags=re.M) == [str(i) for i in range(1, 9)]
    assert "in-repo demo checkpoint resumed at epoch 800" in out
    assert "reference .Model checkpoint resumed at epoch 800" in out
    assert ("the pipelined forward runs in a group of 4 ranks, this run has 1" in out
            and "torchrun --nproc-per-node 4" in out)
    assert "equal to the server's: True" in out
    assert "Train_Set: mean hit accuracy" in out
    assert out.rstrip().endswith("tutorial complete.")
    work = re.search(r"working dir: (\S+);", out).group(1)
    assert not os.path.exists(work)  # the temporary directory is gone


def test_tutorial_on_cuda_without_cuda_raises():
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from transformergrooveinfilling_tpu_torch import tutorial\n"
            "try:\n"
            "    tutorial.main([])\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "raised: tutorial(device='cuda'): CUDA is not available" in proc.stdout
