"""The port's dry-run end to end: qwen3-0.6b decode_32k through
``python -m repro_torch.launch.dryrun`` on the 256- and 512-device meshes
(JAX's ``tests/test_dryrun.py`` contract), and under the flash-decoding
rule.  Each run is a subprocess (its fake process group is process-wide)
where jax and the JAX package are absent; the three start together."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import SHAPES

from test_torch_distributed import MESHES, _jax_argument_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run the module as ``python -m`` would, with jax and the JAX package made
# absent, and report the process's peak resident memory (VmHWM: the rusage
# high-water mark would carry the forking process's across exec)
_RUNNER = """
import runpy, sys
class Absent:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError(f'{name} is absent')
sys.meta_path.insert(0, Absent())
sys.argv = ['repro_torch.launch.dryrun'] + sys.argv[1:]
try:
    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')
finally:
    hwm = [l for l in open('/proc/self/status') if l.startswith('VmHWM:')][0]
    print('maxrss_kb', hwm.split()[1])
"""

RUNS = {
    "pod16x16": [],
    "pod2x16x16": ["--multi-pod"],
    "kvseq": ["--rule", "tp_kvseq"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run started at once; each test waits for its own."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, flags in RUNS.items():
        out = str(tmp / f"{name}.jsonl")
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-c", _RUNNER, "--arch", "qwen3-0.6b", "--shape", "decode_32k",
             "--out", out] + flags,
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}
    try:
        for name, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            rec = json.loads(open(out).readline()) if os.path.exists(out) else None
            done[name] = (proc.returncode, stdout, stderr, rec)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return done


def _ok(run):
    rc, stdout, stderr, rec = run
    assert rc == 0, stdout + stderr
    return stdout, rec


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_dryrun_single_cell(runs, mesh):
    stdout, rec = _ok(runs[mesh])
    assert rec["status"] == "ok"
    assert rec["mesh"] == mesh
    assert rec["chips"] == (512 if mesh == "pod2x16x16" else 256)
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory"]["per_device_total"] > 0
    assert 0 < rec["useful_flops_ratio"] < 10
    assert "[dryrun] 1/1 cells ok" in stdout
    assert "[dryrun] skipped-by-rule llama3-405b long_500k" in stdout


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_dryrun_allocates_nothing(runs, mesh):
    """The step's per-device memory is tens of GB; the process's peak
    resident memory stays a small fraction of it (fake tensors)."""
    stdout, rec = _ok(runs[mesh])
    maxrss = int(stdout.split("maxrss_kb")[-1].split()[0]) * 1024
    assert rec["memory"]["per_device_total"] > 10 * 2**30
    assert maxrss < 3 * 2**30


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_dryrun_argument_bytes_match_jax(runs, mesh):
    """The local shards' bytes of every argument equal the sum of the JAX
    step's shard shapes."""
    _, rec = _ok(runs[mesh])
    want = _jax_argument_bytes("qwen3-0.6b", SHAPES["decode_32k"], MESHES[mesh], "tp")
    assert rec["memory"]["argument_bytes"] == want


def test_kvseq_decode_gathers_no_cache(runs):
    """Under ``tp_kvseq`` each device holds 1/256 of the cache, and no
    all-gather moves the cache: what the step gathers a device (the query
    heads) is under one layer's K shard."""
    _, rec = _ok(runs["kvseq"])
    _, tp = _ok(runs["pod16x16"])
    cell = SHAPES["decode_32k"]
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-0.6b")
    layer_k_shard = (cell.global_batch // 16) * (cell.seq_len // 16) * cfg.n_kv_heads \
        * cfg.head_dim_ * 2
    gathered = rec["roofline"]["collective_breakdown"].get("all-gather", 0) / rec["chips"]
    assert gathered < layer_k_shard
    assert rec["memory"]["argument_bytes"] < tp["memory"]["argument_bytes"] / 8
    assert rec["roofline"]["total_s"] < tp["roofline"]["total_s"]
