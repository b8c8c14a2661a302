"""The port's sharding rules held against the JAX package's, entry for
entry, and the pieces of the distribution layer that run without a process
group: the mesh keys, ``constrain`` outside the dry-run, flash decoding's
combine, and ``tune_cell`` (in a subprocess: its fake process group is
process-wide)."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS, all_cells as j_all_cells
from repro.configs import get_config as j_get_config
from repro.distributed.sharding import RULES as J_RULES
from repro.distributed.sharding import logical_to_spec as j_logical_to_spec
from repro.distributed.sharding import zero_spec as j_zero_spec
from repro.models import input_logical_axes as j_input_logical_axes
from repro.models import input_specs as j_input_specs
from repro.models import param_specs as j_param_specs
from repro.models.spec import is_spec_leaf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init_specs as j_adamw_init_specs
from repro_torch.configs import ARCH_IDS, all_cells, get_config
from repro_torch.distributed import (
    RULES,
    ShardingRule,
    activation_sharding,
    constrain,
    local_shape,
    logical_to_spec,
    mesh_bp_entries,
    mesh_fingerprint,
    opt_state_sharding,
    zero_spec,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import input_logical_axes, input_specs, param_specs
from repro_torch.models.spec import spec_leaves
from repro_torch.optim import AdamWConfig, adamw_init_specs

from test_torch_serve_common import restore_port_registry  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    """Mesh stand-in exposing .shape only (rule logic needs nothing else)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESH1 = _FakeMesh(data=16, model=16)
MESH2 = _FakeMesh(pod=2, data=16, model=16)
MESHES = {"pod16x16": MESH1, "pod2x16x16": MESH2}


# ---------------------------------------------------------------------------
# JAX's five rule tests (tests/test_distributed.py), on the port's functions
# ---------------------------------------------------------------------------


def test_divisibility_guard_replicates_indivisible_axes():
    rule = RULES["tp"]
    # 8 kv heads on a 16-way model axis -> replicated
    spec = logical_to_spec(rule, (22, 2048, 8, 64), ("layers", "embed", "kv_heads", "head_dim"), MESH1)
    assert spec == ()
    # 32 q heads -> sharded
    spec = logical_to_spec(rule, (22, 2048, 32, 64), ("layers", "embed", "q_heads", "head_dim"), MESH1)
    assert spec == (None, None, "model")


def test_pod_axis_dropped_on_single_pod_mesh():
    rule = RULES["tp"]
    assert logical_to_spec(rule, (256, 4096), ("batch", "seq"), MESH1) == ("data",)
    assert logical_to_spec(rule, (256, 4096), ("batch", "seq"), MESH2) == (("pod", "data"),)


def test_axis_never_used_twice_in_one_array():
    rule = ShardingRule.make("t", a="model", b="model")
    assert logical_to_spec(rule, (32, 32), ("a", "b"), MESH1) == ("model",)


def test_zero_spec_adds_data_axis_to_largest_free_dim():
    rule = RULES["tp"]
    spec = zero_spec(rule, (22, 2048, 32, 64), ("layers", "embed", "q_heads", "head_dim"), MESH1)
    assert spec == (None, "data", "model")  # embed dim (largest free, /16)
    assert zero_spec(rule, (), (), MESH1) == ()  # scalar opt count: unsharded


def test_kvseq_rule_shards_cache_slots():
    rule = RULES["tp_kvseq"]
    spec = logical_to_spec(
        rule, (22, 128, 32768, 8, 64),
        ("layers", "batch", "kv_slots", "act_kv", None), MESH1,
    )
    assert spec == (None, "data", "model")


# ---------------------------------------------------------------------------
# Parity with the JAX package on every arch, rule, mesh and leaf
# ---------------------------------------------------------------------------


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=is_spec_leaf)


def _unstacked(shape, axes, spec):
    """A JAX leaf stacked over its layers (leading "layers" axis) as one
    leaf a layer, as the port's tree holds it: (shape, axes, spec, copies)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    if axes and axes[0] == "layers":
        assert spec[0] is None, "a rule sharded the layers axis"
        return tuple(shape[1:]), tuple(axes[1:]), _strip(spec[1:]), shape[0]
    return tuple(shape), tuple(axes), _strip(spec), 1


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_rule_sets_match():
    assert set(RULES) == set(J_RULES)
    for name, rule in RULES.items():
        assert rule.asdict() == J_RULES[name].asdict(), name
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)


def _local_elements(shape, spec, mesh) -> int:
    return math.prod(local_shape(shape, spec, mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_match_jax(arch):
    """Every param spec and every AdamW state leaf: the port's functions on
    JAX's specs give JAX's entries.  The port's own tree, one leaf a layer,
    gets JAX's stacked param specs without their layers entry, leaf for
    leaf; its ZeRO state specs give each device the elements JAX's give it,
    leaf group for leaf group (where JAX's stack puts the ZeRO axes on its
    layers axis, the port puts them on the leaf's own sharded dim)."""
    j_specs = j_param_specs(j_get_config(arch))
    j_opt = j_adamw_init_specs(j_specs, JAdamWConfig())
    specs = param_specs(get_config(arch))
    opt = adamw_init_specs(specs, AdamWConfig())
    assert len(list(spec_leaves(opt))) == 2 * len(list(spec_leaves(specs))) + 1
    for mesh in MESHES.values():
        for name, rule in RULES.items():
            j_rule = J_RULES[name]
            want, got = Counter(), Counter()
            want_zero, got_zero = Counter(), Counter()
            for leaf in _jax_leaves(j_specs):
                j = tuple(j_logical_to_spec(j_rule, leaf.shape, leaf.logical_axes, mesh))
                jz = tuple(j_zero_spec(j_rule, leaf.shape, leaf.logical_axes, mesh))
                assert logical_to_spec(rule, leaf.shape, leaf.logical_axes, mesh) == j
                assert zero_spec(rule, leaf.shape, leaf.logical_axes, mesh) == jz
                shape, axes, spec, n = _unstacked(leaf.shape, leaf.logical_axes, j)
                want[(shape, axes, spec)] += n
                want_zero[(shape, axes)] += _local_elements(leaf.shape, jz, mesh)
            for leaf in spec_leaves(specs):
                got[(leaf.shape, leaf.logical_axes,
                     logical_to_spec(rule, leaf.shape, leaf.logical_axes, mesh))] += 1
            assert got == want, (arch, name)
            o_specs = opt_state_sharding(rule, opt, mesh)
            for leaf, spec in zip(spec_leaves(opt["m"]), _spec_list(o_specs["m"])):
                got_zero[(leaf.shape, leaf.logical_axes)] += _local_elements(leaf.shape, spec, mesh)
            assert got_zero == want_zero, (arch, name)
            for leaf in _jax_leaves(j_opt):  # m, v and the int32 count
                assert zero_spec(rule, leaf.shape, leaf.logical_axes, mesh) == tuple(
                    j_zero_spec(j_rule, leaf.shape, leaf.logical_axes, mesh))


def _spec_list(tree):
    """The specs of a spec tree (dicts and lists; a spec is a tuple), in
    the order ``spec_leaves`` walks the ParamSpec tree."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_list(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_list(v)]
    return [tree]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every input leaf of every cell: JAX's shape, dtype and logical axes,
    and so JAX's spec under every rule on both meshes."""
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    cells = [cell for a, cell in all_cells() if a == arch]
    assert [c.name for c in cells] == [c.name for a, c in j_all_cells() if a == arch]
    for cell in cells:
        j_ins = j_input_specs(j_cfg, cell.kind, cell.global_batch, cell.seq_len)
        j_axes = j_input_logical_axes(j_cfg, cell.kind, j_ins)
        ins = input_specs(cfg, cell.kind, cell.global_batch, cell.seq_len)
        axes = input_logical_axes(cfg, cell.kind, ins)
        assert set(ins) == set(j_ins)
        for part in ins:
            assert set(ins[part]) == set(j_ins[part]), (cell.name, part)
            for key, t in ins[part].items():
                j = j_ins[part][key]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(j.shape), (cell.name, key)
                assert _dtype_name(t.dtype) == np.dtype(j.dtype).name, (cell.name, key)
                assert tuple(axes[part][key]) == tuple(j_axes[part][key]), (cell.name, key)
                for mesh in MESHES.values():
                    for name, rule in RULES.items():
                        assert logical_to_spec(rule, t.shape, axes[part][key], mesh) == tuple(
                            j_logical_to_spec(J_RULES[name], j.shape, j_axes[part][key], mesh))


def _jax_argument_bytes(arch, cell, mesh, rule_name) -> int:
    """One device's bytes of the JAX step's arguments: the shard shape of
    every leaf (params and inputs by ``logical_to_spec``, AdamW state by
    ``zero_spec``), summed in numpy."""
    j_cfg = j_get_config(arch)
    rule = J_RULES[rule_name]

    def shard_bytes(shape, dtype, spec):
        shard = list(shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                names = (entry,) if isinstance(entry, str) else entry
                shard[d] //= int(np.prod([mesh.shape[n] for n in names]))
        return int(np.prod(shard, dtype=np.int64)) * np.dtype(dtype).itemsize

    specs = j_param_specs(j_cfg)
    total = sum(shard_bytes(s.shape, s.dtype, j_logical_to_spec(rule, s.shape, s.logical_axes, mesh))
                for s in _jax_leaves(specs))
    if cell.kind == "train":
        total += sum(shard_bytes(s.shape, s.dtype, j_zero_spec(rule, s.shape, s.logical_axes, mesh))
                     for s in _jax_leaves(j_adamw_init_specs(specs, JAdamWConfig())))
    ins = j_input_specs(j_cfg, cell.kind, cell.global_batch, cell.seq_len)
    axes = j_input_logical_axes(j_cfg, cell.kind, ins)
    for part in ins:
        for key, leaf in ins[part].items():
            total += shard_bytes(leaf.shape, leaf.dtype,
                                 j_logical_to_spec(rule, leaf.shape, axes[part][key], mesh))
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_jax_shard_sums(arch):
    from repro_torch.launch.dryrun import argument_bytes

    for _, cell in [c for c in all_cells() if c[0] == arch]:
        for mesh in MESHES.values():
            for rule_name in RULES:
                want = _jax_argument_bytes(arch, cell, mesh, rule_name)
                assert argument_bytes(arch, cell, mesh, rule_name) == want, (
                    cell.name, mesh.shape, rule_name)


# ---------------------------------------------------------------------------
# Mesh keys (tests/test_serving_traffic.py) and the serving entry points
# ---------------------------------------------------------------------------


def test_mesh_fingerprint_keys_bp():
    from repro_torch.core import BasicParams

    assert mesh_fingerprint(None) == "host"
    assert mesh_bp_entries() == {"mesh": "host"}
    mesh = make_host_mesh()
    assert mesh_fingerprint(mesh) == "data1xmodel1"
    a = BasicParams.make(kernel="k", **mesh_bp_entries(mesh))
    b = BasicParams.make(kernel="k", **mesh_bp_entries(None))
    assert a.fingerprint() != b.fingerprint()  # resharding -> fresh entries
    with activation_sharding(mesh, RULES["tp"]):
        assert mesh_bp_entries() == {"mesh": "data1xmodel1"}
    assert mesh_bp_entries() == {"mesh": "host"}


def test_serving_keys_name_the_mesh():
    """Without a mesh the Server's and the StreamingEngine's keys stay
    "host" (so TuningDB files written before keep recalling); with one,
    they name it."""
    from repro_torch.models import init_params
    from repro_torch.runtime import Server, StreamingEngine

    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert dict(Server(cfg, params)._bp("prefill").entries)["mesh"] == "host"
    keyed = Server(cfg, params, mesh=make_host_mesh())._bp("prefill")
    assert dict(keyed.entries)["mesh"] == "data1xmodel1"
    assert StreamingEngine(cfg, params).mesh is None
    assert StreamingEngine(cfg, params, mesh=make_host_mesh()).mesh.shape == \
        {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# constrain outside the dry-run; flash decoding's combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "whisper-large-v3", "falcon-mamba-7b"])
def test_constrain_is_a_no_op_outside_the_dry_run(arch, monkeypatch):
    """A SMOKE forward is bit-identical with the eleven sites and with each
    site replaced by the identity, outside and inside an
    ``activation_sharding`` context (plain tensors are no DTensors)."""
    from repro_torch.models import encdec, forward, init_params, make_concrete_batch, moe
    from repro_torch.models import transformer

    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_concrete_batch(torch.Generator().manual_seed(1), cfg, "train", 2, 16,
                                device="cpu")["batch"]
    with torch.no_grad():
        sited = forward(params, batch, cfg)
        with activation_sharding(make_host_mesh(), RULES["tp"]):
            inside = forward(params, batch, cfg)
        for mod in (transformer, encdec, moe):
            monkeypatch.setattr(mod, "constrain", lambda x, axes: x)
        bare = forward(params, batch, cfg)
    for a, b, c in zip(sited, inside, bare):
        assert torch.equal(a, c) and torch.equal(b, c)
    x = torch.ones(2, 3, 4)
    assert constrain(x, ("batch", "seq", "act_embed")) is x


@pytest.mark.parametrize("parts", [2, 4])
def test_flash_decoding_combine_matches_unsharded_decode(parts):
    """A SMOKE decode's cache split into ``parts`` along its slots: each
    part's partials, combined as the sharded decode combines them, give
    the unsharded decode attention."""
    from repro_torch.models.attention import combine_partials, decode_attention, decode_partials

    cfg = get_config("qwen3-0.6b", smoke=True)
    B, L, H, KV, hd = 2, 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, H, hd, generator=g)
    k = torch.randn(B, L, KV, hd, generator=g)
    v = torch.randn(B, L, KV, hd, generator=g)
    for length in (L, L - 5, 9):  # a part may hold no valid slot
        want = decode_attention(q, k, v, length)
        n = L // parts
        partials = [decode_partials(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                    length, i * n) for i in range(parts)]
        m, l, o = (torch.stack(t) for t in zip(*partials))
        got = combine_partials(m, l, o, lambda t: t.amax(0, keepdim=True),
                               lambda t: t.sum(0), q.dtype)
        assert torch.allclose(got.reshape(want.shape), want, atol=1e-5, rtol=1e-5), length


# ---------------------------------------------------------------------------
# tune_cell (tests/test_launch_cli.py), in a subprocess
# ---------------------------------------------------------------------------


def test_tune_cell_selects_kvseq_for_decode(tmp_path):
    """The port's tuner picks the KV-length sharding rule on qwen3-0.6b
    decode_32k, as the JAX package's does, and persists one schema-v2
    entry."""
    db = str(tmp_path / "db.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune_cell", "--arch", "qwen3-0.6b",
         "--shape", "decode_32k", "--db", db],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "best PP" in proc.stdout
    assert "'rule': 'tp_kvseq'" in proc.stdout.split("best PP")[1]
    data = json.load(open(db))
    assert data["schema_version"] == 2
    assert len(data["entries"]) == 1  # one BP entry persisted
    assert math.isfinite(float(proc.stdout.split("cost=")[-1].split("s")[0]))


def test_hillclimb_experiments_are_jax_s():
    """The port's hillclimb runs the JAX package's experiments: the same
    cells, labels and keyword arguments (read from the JAX source: that
    module forces 512 XLA devices when imported)."""
    import ast

    def experiments(path):
        tree = ast.parse(open(path).read())
        for node in tree.body:
            if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "EXPERIMENTS":
                return ast.dump(node.value)
        raise AssertionError(f"no EXPERIMENTS in {path}")

    assert experiments(os.path.join(ROOT, "src/repro_torch/launch/hillclimb.py")) == \
        experiments(os.path.join(ROOT, "src/repro/launch/hillclimb.py"))
