"""Slice parity: the JAX registry loop and the port's, end to end on CPU.

``repro.core.autotuned(name)`` and ``repro_torch.core.autotuned(name)``
get the same numpy inputs and must agree; the port's loop tunes cold
(evaluations > 0), recalls from its DB file with zero evaluations through
the fast path, writes a file the JAX ``TuningDB`` reads, and never keys a
shape class the way the JAX package does (a shared file must not see one
fingerprint under two space signatures).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.exb import ops as jax_exb_ops
from repro.kernels.flash_attention import ops as jax_fa_ops
import repro_torch.core as tcore
from repro_torch import carry
from repro_torch.kernels.exb import ops as exb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_kernels import assert_close, exb_numpy, qkv_numpy
from test_torch_scans import TOL as SCAN_TOL, rglru_numpy, ssm_numpy
from test_torch_stress import stress_numpy

NAMES = ["exb", "flash_attention", "stress", "ssm_scan", "rglru_scan"]


def _cases():
    arrays = exb_numpy(seed=21)
    q, k, v = qkv_numpy(seed=22, S=128)
    fields = stress_numpy(seed=23)
    ssm = ssm_numpy(seed=24)
    rglru = rglru_numpy(seed=25)
    return {
        "exb": (
            ({k_: jnp.asarray(a) for k_, a in arrays.items()},),
            (carry.exb_inputs(arrays, device="cpu"),),
        ),
        "flash_attention": (
            tuple(jnp.asarray(a) for a in (q, k, v)),
            carry.attention_inputs(q, k, v, device="cpu"),
        ),
        "stress": (
            ({k_: jnp.asarray(a) for k_, a in fields.items()},),
            (carry.stress_inputs(fields, device="cpu"),),
        ),
        "ssm_scan": (
            tuple(jnp.asarray(a) for a in ssm),
            carry.ssm_inputs(*ssm, device="cpu"),
        ),
        "rglru_scan": (
            tuple(jnp.asarray(a) for a in rglru),
            carry.rglru_inputs(*rglru, device="cpu"),
        ),
    }


def _outputs(out):
    if isinstance(out, dict):
        return tuple(out[k] for k in sorted(out))
    return out if isinstance(out, tuple) else (out,)


def _jax_op(name, path):
    # a two-trial budget keeps the interpret-mode JAX tune short; the
    # comparison is of outputs, which every candidate must agree on
    return jcore.autotuned(name, db=jcore.TuningDB(path), staged=False,
                           trial_budget=2, warm=False)


@pytest.mark.parametrize("name", NAMES)
def test_registry_loops_agree(name, tmp_path):
    jax_args, torch_args = _cases()[name]
    ref = _jax_op(name, str(tmp_path / "jax.json"))(*jax_args)
    out = tcore.autotuned(name, db=tcore.TuningDB(str(tmp_path / "torch.json")))(
        *torch_args
    )
    refs, outs = _outputs(ref), _outputs(out)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        if name in ("ssm_scan", "rglru_scan"):  # their conformance tolerance
            np.testing.assert_allclose(carry.to_numpy(o), np.asarray(r, np.float32),
                                       rtol=SCAN_TOL[0], atol=SCAN_TOL[1], err_msg=name)
        else:
            assert_close(o, r, "float32", name)


@pytest.mark.parametrize("name", NAMES)
def test_cold_tune_then_zero_evaluation_recall(name, tmp_path):
    _, args = _cases()[name]
    path = str(tmp_path / "db.json")
    cold = tcore.autotuned(name, db=tcore.TuningDB(path))
    cold(*args)
    state = cold.resolve(*args)
    assert state.cost_evaluations > 0 and state.tuned
    assert state.prescreen_evaluations == state.region.space.size()

    fresh = tcore.autotuned(name, db=tcore.TuningDB(path))
    fresh(*args)
    recall = fresh.resolve(*args)
    assert recall.cost_evaluations == 0 and recall.from_cache
    assert recall.region.selected == state.region.selected
    slow = fresh.slow_resolutions
    fresh(*args)
    fresh(*args)
    assert fresh.slow_resolutions == slow and len(fresh._fast) == 1


@pytest.mark.parametrize("name", NAMES)
def test_port_db_file_loads_in_the_jax_tuningdb(name, tmp_path):
    _, args = _cases()[name]
    path = str(tmp_path / "db.json")
    op = tcore.autotuned(name, db=tcore.TuningDB(path))
    op(*args)
    state = op.resolve(*args)
    jax_db = jcore.TuningDB(path)
    assert jax_db.fingerprints() == tcore.TuningDB(path).fingerprints()
    jax_bp = jcore.BasicParams.make(**state.bp.asdict())
    assert jax_bp.fingerprint() == state.bp.fingerprint()
    assert jax_db.tuned_point(
        jax_bp, space_signature=state.region.space_signature
    ) == state.region.selected


def test_no_port_bp_equals_its_jax_counterpart():
    cases = _cases()
    (jax_inp,), (torch_inp,) = cases["exb"]
    assert (jax_exb_ops.shape_class(jax_inp).fingerprint()
            != exb_ops.shape_class(torch_inp).fingerprint())
    jax_qkv, torch_qkv = cases["flash_attention"]
    jbp = jax_fa_ops.shape_class(*jax_qkv)
    tbp = fa_ops.shape_class(*torch_qkv)
    assert jbp.fingerprint() != tbp.fingerprint()
    # the difference is the framework and the device family, not the shape
    assert tbp["framework"] == "torch" and tbp["backend"] == "cpu"
    assert {k: tbp[k] for k in ("seq", "hd", "dtype")} == {
        k: jbp[k] for k in ("seq", "hd", "dtype")
    }


def test_fast_dispatch_keys_on_the_device():
    from repro_torch.core.autotuned import _arg_sig

    t = torch.zeros(2, 3)
    meta = torch.zeros(2, 3, device="meta")
    assert _arg_sig(t) != _arg_sig(meta)
    assert _arg_sig(t) == ((2, 3), torch.float32, torch.device("cpu"))


def test_one_registry_per_package():
    assert tcore.REGISTRY is not jcore.REGISTRY
    # the five ported kernels and the flash backward (no JAX registry name)
    assert set(tcore.kernel_names()) == set(NAMES) | {"flash_attention_bwd"}
    assert "exb" in jcore.kernel_names()
    assert tcore.get_kernel("exb").make_region is not jcore.get_kernel("exb").make_region
