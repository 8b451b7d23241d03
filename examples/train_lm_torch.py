"""Train any of the 10 assigned LM architectures (reduced config) through
the PyTorch port, with the GIDS-fed token pipeline, checkpoint/restart and
WSD or cosine schedule (the counterpart of examples/train_lm.py):

    # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --arch minicpm_2b \
        --steps 200 --schedule wsd
    # on the CPU
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \
        --arch qwen2_1_5b --steps 20 --batch 2 --seq 32

This is a thin veneer over the trainer (repro_torch.launch.train); kill it
mid-run and rerun with the same --ckpt-dir to watch it resume.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    args = sys.argv[1:] or ["--arch", "minicpm_2b", "--steps", "200",
                            "--schedule", "wsd", "--batch", "8",
                            "--seq", "128", "--ckpt-dir",
                            str(Path(tempfile.gettempdir()) / "lm_ckpt")]
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--reduced"] + args
    sys.exit(subprocess.call(cmd, env={**os.environ,
                                       "PYTHONPATH": str(ROOT / "src")}))
