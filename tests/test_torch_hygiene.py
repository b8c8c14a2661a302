"""The port stands alone: importing it loads neither jax nor the JAX
package, its serving modules import and serve with both made absent, no
source line imports them, and ``chip_smoke.py`` fails loudly (non-zero,
no result line) without a card or without the repository."""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


SERVING_MODULES = (
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.core.program",
    "repro_torch.obs.metrics", "repro_torch.obs.explain", "repro_torch.runtime",
    "repro_torch.runtime.serve", "repro_torch.runtime.engine",
    "repro_torch.runtime.background_tuner", "repro_torch.runtime.chaos",
    "repro_torch.launch", "repro_torch.launch.serve",
)


def test_serving_modules_import_with_jax_absent():
    """The serving slice's modules import, and serve, in a process where
    importing jax or the JAX package raises."""
    assert set(SERVING_MODULES) <= set(_modules())
    code = (
        "import importlib, sys\n"
        "class Absent:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'{name} is absent')\n"
        "sys.meta_path.insert(0, Absent())\n"
        f"for m in {list(SERVING_MODULES)!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import synthetic_requests\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.runtime import StreamingEngine\n"
        "import torch\n"
        "cfg = get_config('tinyllama-1.1b', smoke=True)\n"
        "params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "out = StreamingEngine(cfg, params, n_blocks=2, max_len=8).serve(\n"
        "    synthetic_requests(cfg, 2, 4, 3))\n"
        "assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


TRAINING_MODULES = (
    "repro_torch.tree", "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager", "repro_torch.runtime.train",
    "repro_torch.launch.train",
)


def test_training_modules_import_and_train_with_jax_absent(tmp_path):
    """The training slice's modules import, and train and checkpoint, in a
    process where importing jax or the JAX package raises."""
    assert set(TRAINING_MODULES) <= set(_modules())
    code = (
        "import importlib, sys\n"
        "class Absent:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'{name} is absent')\n"
        "sys.meta_path.insert(0, Absent())\n"
        f"for m in {list(TRAINING_MODULES)!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.data import SyntheticLMDataset\n"
        "from repro_torch.optim import AdamWConfig\n"
        "from repro_torch.runtime import Trainer, TrainLoopConfig\n"
        "cfg = get_config('tinyllama-1.1b', smoke=True)\n"
        "loop = TrainLoopConfig(total_steps=2, save_every=1, ckpt_dir=sys.argv[1])\n"
        "hist = Trainer(cfg, AdamWConfig(), loop, device='cpu').run(\n"
        "    SyntheticLMDataset(cfg, global_batch=2, seq_len=8))\n"
        "assert len(hist['loss']) == 2\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [
        f"{f.relative_to(ROOT)}:{i}: {line}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if IMPORT_RE.match(line)
    ]
    assert hits == []
    assert IMPORT_RE.match("from repro.core import x")
    assert not IMPORT_RE.match("from repro_torch.core import x")


def test_every_kernel_source_names_what_it_replaces():
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert {p.stem for p in sources} == {
        "exb", "flash_attention", "flash_attention_sm90", "stress", "ssm_scan", "rglru_scan",
        "loop_nest", "flash_attention_bwd_f32",
        "flash_attention_bwd_sm90", "ssm_scan_bwd", "rglru_scan_bwd",
    }
    for src in sources:
        text = src.read_text()
        # loop_nest replaces core/exchange.py's LoopNest.variant_fn, the flash
        # backward models/attention.py's _flash_bwd and the scans' backwards
        # XLA's derivatives of the models' lax.scan: none is a Pallas kernel
        where = {"loop_nest": "src/repro/core/",
                 "flash_attention_bwd_f32": "src/repro/models/",
                 "flash_attention_bwd_sm90": "src/repro/models/",
                 "ssm_scan_bwd": "src/repro/models/",
                 "rglru_scan_bwd": "src/repro/models/"}.get(src.stem, "src/repro/kernels/")
        assert f"Replaces: {where}" in text
        assert "What bounds it" in text and "Design." in text


def _smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = _env()
    env.pop("PYTHONPATH")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "src/repro_torch is not beside" in out.stderr
