"""The MoE family's train cells under the ``tp_seq`` rule in the port's
dry-run: granite-moe-1b-a400m and llama4-scout-17b-a16e at their SMOKE
configs on a (2, 2) and a (2, 2, 2) mesh lower, and each device's argument
bytes equal the JAX step's.  The backward of these cells once raised
``DataDependentOutputException``: the MoE block's output, left to the
residual add in its groups' placements, took its gradient back through the
reshape as a strided shard, whose redistribution reads shard offsets off a
fake tensor.  JAX's dry-run lowers and compiles the same (2, 2) cells (run
here too); its compiled argument bytes are the port's.  Each package runs in
a subprocess of its own (the port's fake process group is process-wide, and
JAX fixes its host device count at import); the three start together."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ShapeCell

from test_torch_distributed import _FakeMesh, _jax_argument_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
MESHES = {"pod2x2": ((2, 2), _FakeMesh(data=2, model=2)),
          "pod2x2x2": ((2, 2, 2), _FakeMesh(pod=2, data=2, model=2))}
CELL = ShapeCell("smoke", "train", 64, 8)

_PORT = """
import json, sys
from repro_torch.configs import ShapeCell
from repro_torch.launch.dryrun import run_cell
shape = tuple(json.loads(sys.argv[1]))
for arch in json.loads(sys.argv[2]):
    rec = run_cell(arch, ShapeCell('smoke', 'train', 64, 8), len(shape) == 3, 'tp_seq',
                   verbose=False, mesh_shape=shape, smoke=True)
    print('RECORD', json.dumps(rec))
"""

_JAX = """
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import dataclasses, json, sys
from repro.configs import ShapeCell, get_config
from repro.launch.dryrun import run_cell
for arch in json.loads(sys.argv[1]):
    smoke = get_config(arch, smoke=True)
    over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke) if f.name != 'name'}
    rec = run_cell(arch, ShapeCell('smoke', 'train', 64, 8), False, 'tp_seq', verbose=False,
                   cfg_overrides=over, mesh_shape=(2, 2))
    print('RECORD', json.dumps(rec))
"""


def _records(stdout):
    return {r["arch"]: r for r in (json.loads(line.split(" ", 1)[1])
                                   for line in stdout.splitlines() if line.startswith("RECORD "))}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _PORT, json.dumps(shape), json.dumps(ARCHS)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (shape, _) in MESHES.items()}
    procs["jax"] = subprocess.Popen([sys.executable, "-c", _JAX, json.dumps(ARCHS)], env=env,
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
    done = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            done[name] = (proc.returncode, stderr, _records(stdout))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return done


def _record(runs, name, arch):
    rc, stderr, recs = runs[name]
    assert rc == 0 and arch in recs, stderr[-4000:]
    return recs[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_cell_lowers_under_tp_seq(runs, arch, mesh):
    rec = _record(runs, mesh, arch)
    assert rec["status"] == "ok" and rec["rule"] == "tp_seq" and rec["kind"] == "train"
    assert rec["chips"] == (8 if mesh == "pod2x2x2" else 4)
    assert rec["memory"]["per_device_total"] > 0
    assert rec["roofline"]["compute_s"] > 0 and rec["roofline"]["memory_s"] > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_cell_argument_bytes_match_jax(runs, arch, mesh):
    rec = _record(runs, mesh, arch)
    want = _jax_argument_bytes(arch, CELL, MESHES[mesh][1], "tp_seq", smoke=True)
    assert rec["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_lowers_the_same_cell(runs, arch):
    """The reference lowers and compiles the (2, 2) cell, and its compiled
    argument bytes are the port's."""
    ref = _record(runs, "jax", arch)
    assert ref["status"] == "ok"
    assert _record(runs, "pod2x2", arch)["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
