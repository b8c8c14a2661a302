"""The port stands alone: importing it loads neither jax nor the JAX
package, no source line imports them, and ``chip_smoke.py`` fails loudly
(non-zero, no result line) without a card or without the repository."""
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
        "loop_nest",
    }
    for src in sources:
        text = src.read_text()
        # loop_nest replaces core/exchange.py's LoopNest.variant_fn, not a Pallas kernel
        where = "src/repro/" if src.stem == "loop_nest" else "src/repro/kernels/"
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
