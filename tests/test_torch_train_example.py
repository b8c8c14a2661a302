"""``examples/torch_train_lm.py`` on the CPU: it builds the same widened
model as the JAX package's ``examples/train_lm.py``, runs a few steps of
the port's training loop (checkpoints included), reports the loss drop
and the steps a second, and exits non-zero when the drop misses its 20 %
bar, as a few steps do."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

from repro.configs import get_config as jax_config
from repro.models import analytic_param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.models import analytic_param_count

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "torch_train_lm.py"




def _widened(cfg, s=2.0):
    return cfg.with_(d_model=int(cfg.d_model * s), d_ff=int(cfg.d_ff * s),
                     n_layers=max(2, int(cfg.n_layers * min(s, 2))),
                     vocab_size=cfg.vocab_size * 4)


def test_the_example_model_is_the_jax_examples():
    port = _widened(get_config("tinyllama-1.1b", smoke=True))
    jax = _widened(jax_config("tinyllama-1.1b", smoke=True))
    assert analytic_param_count(port) == jax_param_count(jax)


def test_the_example_trains_a_few_steps_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(EXAMPLE), "--device", "cpu", "--steps", "6", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert "steps: 6" in out.stdout, out.stderr
    assert re.search(r"\d+\.\d steps/s on CPU", out.stdout)
    drop = float(re.search(r"\((-?\d+\.\d)% drop\)", out.stdout).group(1))
    assert any((tmp_path / "ckpt").iterdir())  # the loop checkpointed
    # six steps do not reach the bar: the run says so and fails
    assert drop < 20 and out.returncode != 0
    assert "did not drop >= 20%" in out.stderr
