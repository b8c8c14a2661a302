"""The port's AdamW against the JAX package's, on random trees of float32
and bf16 leaves: ``adamw_update`` (float32 and bf16 moments, the clip
active and inactive, two steps), ``lr_at`` and ``global_norm``; and the
counterparts of ``tests/test_runtime.py``'s optimizer checks.

Tolerance: float32 ``DEFAULT_TOL`` on every float32 leaf and metric; a bf16
leaf (a parameter or a bf16 moment) within one bf16 ulp of JAX's (both
round the same float32 value, which may fall either side of a rounding
boundary)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_init, adamw_update as jax_update
from repro.optim import global_norm as jax_global_norm, lr_at as jax_lr_at
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at
from repro_torch.tree import flatten

SHAPES = {"a": (3, 5), "b": [(7,), (2, 2, 3)], "c": {"w": (4, 6), "z": ()}}


def _tree(rng, scale=1.0):
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        if isinstance(node, list):
            return [make(v) for v in node]
        return np.asarray(rng.standard_normal(node) * scale, np.float32)
    return make(SHAPES)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _assert_tree(port, ref, label):
    got, _ = flatten(port)
    want = jax.tree.leaves(ref)
    assert len(got) == len(want)
    rtol, atol = DEFAULT_TOL["float32"]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        gn = g.float().numpy()
        if g.dtype == torch.bfloat16:
            ulp = np.abs(w) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(gn - w) <= ulp), f"{label} leaf {i}"
        else:
            np.testing.assert_allclose(gn, w, rtol=rtol, atol=atol, err_msg=f"{label} leaf {i}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # the clip inactive, then active
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments, grad_scale, param_dtype):
    rng = np.random.default_rng(7)
    params_np = _tree(rng)
    grads_np = [_tree(rng, grad_scale) for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, moment_dtype=moments)
    jdt, tdt = ((jnp.float32, torch.float32) if param_dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jp = _map(lambda a: jnp.asarray(a, jdt), params_np)
    tp = _map(lambda a: torch.from_numpy(a).to(tdt), params_np)
    js, ts = jax_init(jp, jcfg), adamw_init(tp, tcfg)
    before = [t.clone() for t in flatten(tp)[0]]
    for step, g in enumerate(grads_np):
        jp, js, jm = jax_update(_map(lambda a: jnp.asarray(a, jdt), g), js, jp, jcfg)
        tp_new, ts, tm = adamw_update(_map(lambda a: torch.from_numpy(a).to(tdt), g), ts, tp,
                                      tcfg)
        if step == 0:  # pure: the arguments are left as they were
            assert all(torch.equal(a, b) for a, b in zip(flatten(tp)[0], before))
        tp = tp_new
        label = f"step {step}"
        _assert_tree(tp, jp, label + " params")
        _assert_tree(ts["m"], js["m"], label + " m")
        _assert_tree(ts["v"], js["v"], label + " v")
        assert int(ts["count"]) == int(js["count"])
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-6,
                                       err_msg=label + key)
    assert flatten(ts["m"])[0][0].dtype == (torch.float32 if moments == "float32"
                                            else torch.bfloat16)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 55, 100, 150])
def test_lr_at_matches_jax(step):
    kw = dict(lr=0.3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = float(lr_at(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(jax_lr_at(JaxAdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(8)
    tree = _tree(rng)
    got = float(global_norm(_map(torch.from_numpy, tree)))
    want = float(jax_global_norm(_map(jnp.asarray, tree)))
    assert got == pytest.approx(want, rel=1e-6)


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(150):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_grad_clip_and_schedule():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_at(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(lr_at(cfg, torch.tensor(100))) == pytest.approx(cfg.min_lr_ratio, rel=1e-2)
    params = {"w": torch.zeros(3)}
    state = adamw_init(params, cfg)
    _, _, metrics = adamw_update({"w": torch.full((3,), 1e6)}, state, params, cfg)
    assert float(metrics["grad_norm"]) > 1e6  # reported before the clip


def test_adamw_bf16_moment_compression():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    params2, state2, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)}, state,
                                      params, cfg)
    assert state2["v"]["w"].dtype == torch.bfloat16
    assert params2["w"].dtype == torch.bfloat16


def test_the_update_in_groups_of_leaves_changes_no_bit(monkeypatch):
    """The update runs over runs of leaves of at most GROUP_ELEMENTS
    elements (its float32 temporaries bounded at any model size); every op
    is elementwise, so any grouping gives the same bits as one group."""
    from repro_torch.optim import adamw as adamw_mod

    gen = torch.Generator().manual_seed(3)
    shapes = ((300, 100), (50,), (7, 7), (4000,))
    params = {"a": [torch.randn(s, generator=gen).to(torch.bfloat16 if len(s) == 2 else
                                                        torch.float32) for s in shapes]}
    grads = {"a": [torch.randn(s, generator=gen).to(p.dtype) for s, p in
                   zip(shapes, params["a"])]}
    cfg = adamw_mod.AdamWConfig()
    state = adamw_mod.adamw_init(params, cfg)
    whole = adamw_mod.adamw_update(grads, state, params, cfg)
    monkeypatch.setattr(adamw_mod, "GROUP_ELEMENTS", 100)
    leaves = adamw_mod.flatten(params)[0]
    assert list(adamw_mod._groups(leaves)) == [[0], [1, 2], [3]]
    grouped = adamw_mod.adamw_update(grads, state, params, cfg)
    for tree_w, tree_g in ((whole[0], grouped[0]), (whole[1]["m"], grouped[1]["m"]),
                           (whole[1]["v"], grouped[1]["v"])):
        for w, g in zip(adamw_mod.flatten(tree_w)[0], adamw_mod.flatten(tree_g)[0]):
            assert w.dtype == g.dtype and torch.equal(w, g)
