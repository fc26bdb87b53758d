"""The import guard's shared parts: every check runs in a subprocess of its
own where neither JAX nor PIL is installed, nor rouge_score or nltk
(``BLOCKED``), on few threads, and ends by asserting that nothing of the
JAX package was imported (``CHECK_BLOCKED``). ``run`` starts one such
subprocess with a wide time limit; ``test_torch_no_jax.py`` and
``test_torch_no_jax_train.py`` hold the checks, grouped as imports and
serving, eval, training, and the mesh, so that ``--dist loadfile`` spreads
them over workers."""

import os
import subprocess
import sys

from _torch_parity import REPO_ROOT

# Under six busy test workers a check takes several times its idle time;
# the limit leaves wide room over that.
TIMEOUT_S = 600

BLOCKED = r"""
import sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
sys.modules["PIL"] = None
sys.modules["rouge_score"] = None
sys.modules["nltk"] = None
import torch
torch.set_num_threads(2)  # the subprocesses share the CPU with the test workers
"""
CHECK_BLOCKED = r"""
assert sys.modules["jax"] is None and sys.modules["PIL"] is None
assert sys.modules["rouge_score"] is None and sys.modules["nltk"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "open_o3_video_tpu"]
print("NO_JAX_OK")
"""

# A tiny Qwen2.5-VL, its processor and an image request (``req``).
SETUP = r"""
import numpy as np
import torch

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params

cfg = Qwen25VLConfig.tiny()
proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
imgs = list(np.random.default_rng(0).integers(0, 256, (2, 3, 56, 84), dtype=np.uint8))
x = proc("<|vision_start|><|image_pad|><|vision_end|>" * 2 + "Why?", images=imgs)
weights = params.init(cfg, 0, torch.device("cpu"))
req = Request(x.input_ids, x.pixel_patches, x.grid_thw, cfg.image_token_id)
"""


def run(script: str) -> None:
    """``script`` under the blocks, in a subprocess; fails with its stderr."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO_ROOT, os.path.join(REPO_ROOT, "tests")]),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED + script + CHECK_BLOCKED], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=TIMEOUT_S,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
