"""The guard that a run measures the port alone: top-level module names
compared whole, so ``repro_torch`` passes and ``repro`` does not."""
import subprocess
import sys

from harness.guard import forbidden_modules

from conftest import BENCH


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.models", "reproducible", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["repro.core.db"]) == ["repro"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.cell, harness.train, harness.serve, harness.control\n"
            "import reference.moe_lm, reference.mamba_lm\n"
            "import repro_torch.runtime, repro_torch.models, repro_torch.optim\n"
            "from harness.guard import forbidden_modules\n"
            "print(forbidden_modules())\n" % (str(BENCH), str(BENCH.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    from harness import cell as run_cell

    monkeypatch.setitem(sys.modules, "repro", sys.modules["harness"])
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {}}
    assert run_cell.finish(line, ["[run] details"]) == 3
    out = capsys.readouterr()
    assert out.out == ""
    assert "repro" in out.err


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "granite-moe-1b-a400m.train_4k", "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=str(BENCH.parent))
    import torch

    if torch.cuda.is_available():  # a card is present: the run measures
        return
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
