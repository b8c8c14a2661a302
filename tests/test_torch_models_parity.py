"""Shared by the other ``tests/test_torch_models_*.py`` (this module holds
no test itself): run one arch's serving entry points in the JAX package
and in the port on the same weights and inputs, and compare.  An arch runs
at its SMOKE config, or, given a ``cut`` (a tuple of (field, value) pairs),
at its FULL config with those fields replaced (:func:`configs`).

The weights are the JAX ``init_params`` tree, carried across by
``repro_torch.carry.model_params``; the inputs are drawn with numpy from a
seed.  Each side runs ``forward``, ``prefill_fn`` (with room for the
decode steps) and ``STEPS`` ``decode_fn`` steps fed the JAX side's greedy
tokens, so a near-tie cannot send the two down different sequences; the
port's own greedy tokens are compared separately.  Two weight modes: the
JAX package's bf16 weights, and the same weights cast to float32 on both
sides.

Tolerances (stated here, used by every parity test):

* float32 weights: every row (the last axis) within ``F32_ROW_REL`` =
  1e-3 of the row's largest ``|reference|`` element, and equal greedy
  tokens; a bf16 cache leaf is held to the bf16 rule (it is a rounding of
  float32 values that may fall one ulp apart);
* bf16 weights: the worst row's ``‖port − jax‖ / ‖jax‖`` at most
  ``BF16_ROW`` = 4·2⁻⁸ (four bf16 ulps), as ``PERF.md`` §2.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_fn as jax_decode, init_params, param_specs
from repro.models import prefill_fn as jax_prefill
from repro.models import encdec as jax_encdec, transformer as jax_transformer
from repro_torch import carry
from repro_torch import models as tm
from repro_torch.configs import get_config

F32_ROW_REL = 1e-3
BF16_ROW = 4 * 2.0 ** -8
STEPS = 8
B = 2


def configs(arch: str, cut=None):
    """(JAX config, port config) of ``arch``: the SMOKE configs, or with
    ``cut`` the FULL configs with its fields replaced."""
    if cut is None:
        return jax_config(arch, smoke=True), get_config(arch, smoke=True)
    return jax_config(arch).with_(**dict(cut)), get_config(arch).with_(**dict(cut))


def prompt_len(cfg) -> int:
    """The prompt: past the hybrid window, so the local-window path and
    the ring quirk run; longer than the VLM's vision tokens."""
    if cfg.family == "hybrid":
        return cfg.local_window + 8
    return max(16, cfg.n_vision_tokens + 8) if cfg.family == "vlm" else 16


def inputs(cfg, seed: int, seq: Optional[int] = None) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    S = seq or prompt_len(cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab_size - 1, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        text = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.stack([text, text // 2, text % 5]).astype(np.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, seed: int, cut=None):
    """``init_params`` under one ``jax.jit`` (a third of its time op by op)."""
    specs = param_specs(configs(arch, cut)[0])
    return jax.jit(lambda key: init_params(key, specs))(jax.random.PRNGKey(seed))


def _temper(params):
    """wq and wk of every attention drawn at the fan-in of d_model: scaled
    by sqrt(heads / d_model).  The JAX init takes a (d, heads, hd)
    projection's fan-in as its heads (``ROADMAP.md`` §C), so at a published
    width its scores reach std ~180 and every softmax is nearly one-hot: a
    one-ulp bf16 difference flips which key it picks (``chip_smoke.py``
    ``temper`` does the same on the card)."""
    def one(path, a):
        if getattr(path[-1], "key", None) in ("wq", "wk"):
            return (a * np.sqrt(a.shape[-2] / a.shape[-3])).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(one, params)


def jax_params(arch: str, mode: str, seed: int = 0, cut=None):
    """The JAX ``init_params`` weights of ``arch``'s SMOKE config (or its
    ``cut`` FULL config; drawn once per process), or their float32 cast;
    a mode "<mode>-tempered" has wq and wk tempered (:func:`_temper`)."""
    params = dict(_jax_init(arch, seed, cut))
    if mode.endswith("-tempered"):
        params = _temper(params)
    if mode.startswith("f32"):
        encoder = params.pop("enc_layers", None)
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        if encoder is not None:
            # the JAX encoder's scan carries bf16 frames, and float32 layer
            # weights would promote its carry (a type error), so its layers
            # keep their bf16 weights; the rest of the model is float32
            params["enc_layers"] = encoder
    return params


def _jax_forward(params, batch, cfg):
    if cfg.is_encoder_decoder:
        return jax_encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    return jax_transformer.forward(params, batch["tokens"], cfg,
                                   positions=batch.get("positions"),
                                   vision_embeds=batch.get("vision_embeds"))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if hasattr(a, "dtype") else a, tree)


def run_jax(arch: str, mode: str, seed: int = 0, cut=None, seq: Optional[int] = None,
            steps: int = STEPS) -> Dict[str, Any]:
    """forward logits, prefill logits and cache, and ``steps`` greedy decode
    steps (tokens and logits) of the JAX package, as numpy, run op by op
    (``jax.disable_jit``): compiled, XLA keeps excess precision across the
    bf16 operations it fuses, and the JAX forward differs from its own
    op-by-op run by 3.7% (worst row) at tinyllama's SMOKE config."""
    params = jax_params(arch, mode, seed, cut)
    with jax.disable_jit():
        return _run_jax(arch, params, seed, cut, seq, steps)


def _run_jax(arch: str, params, seed: int, cut=None, seq: Optional[int] = None,
             steps: int = STEPS) -> Dict[str, Any]:
    cfg = configs(arch, cut)[0]
    batch_np = inputs(cfg, seed, seq)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    fwd, _ = _jax_forward(params, batch, cfg)
    S = batch_np["tokens"].shape[1]
    logits, cache = jax_prefill(params, batch, cfg, capacity=S + steps)
    out = {"params": jax.tree.map(np.asarray, params), "batch": batch_np,
           "forward": np.asarray(fwd), "prefill": np.asarray(logits),
           "cache": _np(cache), "tokens": [], "steps": []}
    extra = {"frames": batch["frames"]} if cfg.is_encoder_decoder else {}
    for _ in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache = jax_decode(params, {"tokens": tok, **extra}, cache, cfg)
        out["tokens"].append(np.asarray(tok))
        out["steps"].append(np.asarray(logits))
    out["final_cache"] = _np(cache)
    return out


def run_port(arch: str, mode: str, ref: Dict[str, Any], cut=None) -> Dict[str, Any]:
    """The same in the port, on the CPU, on the carried weights, decode fed
    the JAX side's tokens; also the port's own greedy tokens."""
    cfg = configs(arch, cut)[1]
    params = carry.model_params(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(np.array(v)).long() if v.dtype == np.int32
             else torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    fwd, _ = tm.forward(params, batch, cfg)
    S = batch["tokens"].shape[1]
    logits, cache = tm.prefill_fn(params, batch, cfg, capacity=S + len(ref["tokens"]))
    out = {"forward": fwd.numpy(), "prefill": logits.numpy(), "cache": _cache_np(cache),
           "tokens": [], "steps": []}
    extra = {"frames": batch["frames"]} if cfg.is_encoder_decoder else {}
    for tok in ref["tokens"]:
        out["tokens"].append(torch.argmax(logits, dim=-1).numpy()[:, None])
        logits, cache = tm.decode_fn(params, {"tokens": torch.tensor(tok).long(), **extra},
                                     cache, cfg)
        out["steps"].append(logits.numpy())
    out["final_cache"] = _cache_np(cache)
    return out


def _cache_np(cache):
    """A copy (decode writes the cache's tensors in place)."""
    return {k: v.float().numpy().copy() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def row_errors(got: np.ndarray, ref: np.ndarray):
    """(worst row's max |err| over its max |ref|, worst row's ‖err‖/‖ref‖)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    scale = np.maximum(np.abs(ref).max(axis=-1), 1e-30)
    norm = np.maximum(np.linalg.norm(ref, axis=-1), 1e-30)
    return float((err.max(axis=-1) / scale).max()), float((np.linalg.norm(got - ref, axis=-1) / norm).max())


def assert_rows(got, ref, mode: str, what: str, bf16_leaf: bool = False) -> None:
    rel_max, rel_norm = row_errors(got, ref)
    if mode.startswith("f32") and not bf16_leaf:
        assert rel_max <= F32_ROW_REL, f"{what}: row max error {rel_max} > {F32_ROW_REL}"
    else:
        assert rel_norm <= BF16_ROW, f"{what}: worst row error {rel_norm} > {BF16_ROW}"


def assert_cache(got: Dict[str, Any], ref: Dict[str, Any], mode: str, what: str) -> None:
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for key, r in ref.items():
        g = got[key]
        if key == "len":
            assert int(g) == int(r), f"{what} len {g} != {r}"
            continue
        bf16_leaf = not key.endswith("h")  # k, v, conv windows are bf16
        assert_rows(g, r, mode, f"{what} cache {key}", bf16_leaf=bf16_leaf)


def check_arch(arch: str, mode: str, ref: Dict[str, Any], port: Dict[str, Any]) -> None:
    """Every comparison of one arch in one weight mode."""
    check_forward(arch, mode, ref, port)
    check_prefill(arch, mode, ref, port)
    check_decode(arch, mode, ref, port)


def check_forward(arch: str, mode: str, ref: Dict[str, Any], port: Dict[str, Any]) -> None:
    assert_rows(port["forward"], ref["forward"], mode, f"{arch} {mode} forward")


def check_prefill(arch: str, mode: str, ref: Dict[str, Any], port: Dict[str, Any]) -> None:
    """The last logits and every cache leaf."""
    assert_rows(port["prefill"], ref["prefill"], mode, f"{arch} {mode} prefill")
    assert_cache(port["cache"], ref["cache"], mode, f"{arch} {mode} prefill")
    if mode == "f32":
        assert np.array_equal(np.argmax(port["prefill"], -1), np.argmax(ref["prefill"], -1))
    check_decode(arch, mode, ref, port)


def check_decode(arch: str, mode: str, ref: Dict[str, Any], port: Dict[str, Any]) -> None:
    """Each decode step's logits; with float32 weights also the greedy
    tokens and the cache after the last step (with bf16 weights a
    reduction summed in another order flips a bf16 rounding now and then,
    and one flipped input to a cross attention moved a cached K row by
    1.8%: the logits, which the rule covers, moved 1.2%)."""
    for i, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        assert_rows(got, want, mode, f"{arch} {mode} decode step {i}")
    if mode == "f32":
        for i, (got, want) in enumerate(zip(port["tokens"], ref["tokens"])):
            assert np.array_equal(got, want), f"{arch} greedy token {i}: {got} != {want}"
        assert_cache(port["final_cache"], ref["final_cache"], mode, f"{arch} {mode} decode")


class Runs:
    """The JAX and port runs of each (arch, mode) (and ``cut``, prompt length
    and decode steps), made once per test module."""

    def __init__(self) -> None:
        self._runs: Dict[Any, Any] = {}

    def __call__(self, arch: str, mode: str, cut=None, seq: Optional[int] = None,
                 steps: int = STEPS):
        key = (arch, mode, cut, seq, steps)
        if key not in self._runs:
            ref = run_jax(arch, mode, cut=cut, seq=seq, steps=steps)
            self._runs[key] = (ref, run_port(arch, mode, ref, cut))
        return self._runs[key]
