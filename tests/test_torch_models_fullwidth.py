"""The dense-GQA, MoE, VLM and encoder-decoder families at their published
widths against the JAX package on the CPU: each FULL config keeps its heads,
head dim, ``qk_norm``, experts, top-k and capacity factor and M-RoPE
sections, cut to 2 layers (Whisper 2 + 2), a 512-token vocabulary, 64
encoder frames and 16 vision tokens (qwen2.5-32b's d_ff to 1024).  Each runs
``forward``, ``prefill_fn`` and 4 greedy ``decode_fn`` steps on the JAX
``init_params`` weights in float32 and in bf16, with the parity helper's
tolerances (``test_torch_models_parity``), and one float32
``make_train_step`` update against JAX's (``test_torch_train_step``'s
tolerances).  The weights have wq and wk tempered (the helper's
"-tempered" modes, as ``chip_smoke.py`` checks end to end): at a
published width the JAX init's attention is chaotic (``ROADMAP.md`` §C),
and on its own weights the two packages' last-bit differences flip
softmaxes (granite-moe's bf16 forward: 10 of 256 rows past 4·2⁻⁸, none of
them at an MoE near-tie; Whisper's float32 forward, through its bf16
encoder, a row 40% off).  The MoE case routes 256 tokens as one group (B=2,
128 positions; 64 in the train step's B=4), and its capacity drops some
assignments, so the overflow path is compared too; in bf16 it routes on
JAX's expert picks (:func:`routed_runs`), in float32 on its own."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models_parity as P
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.layers import dot
from test_torch_train_step import check_train_step_matches_jax

CUT = (("n_layers", 2), ("vocab_size", 512))
CUTS = {
    "qwen3-0.6b": CUT,
    "granite-moe-1b-a400m": CUT,
    "qwen2-vl-2b": CUT + (("n_vision_tokens", 16),),
    "whisper-large-v3": CUT + (("n_encoder_layers", 2), ("encoder_len", 64)),
    "qwen2.5-32b": CUT + (("d_ff", 1024),),
}
SEQ = {"granite-moe-1b-a400m": 128}  # 2 x 128 = 256 tokens in the MoE's one group
TRAIN_SEQ = {"granite-moe-1b-a400m": 64}  # 4 x 64 = 256
STEPS = 4
MODES = ["f32-tempered", "bf16-tempered"]
ARCHS = list(CUTS)


def routed_runs(arch: str, mode: str):
    """The JAX and port runs of an MoE case with the port routing every
    token to the experts JAX picked (recorded from JAX's MoE blocks in call
    order, replayed in the port's), and how many of the port's own picks
    differed.  In bf16 the router's logits are bf16-rounded, and a token
    whose 8th and 9th logits lie within an ulp (11% of this case's) picks
    by the last bits that the packages sum in different orders."""
    import repro.models.transformer as jax_transformer

    recorded, block = [], jax_transformer.moe_block

    def recording(x, p, cfg):
        logits = jnp.einsum("td,de->te", x.reshape(-1, x.shape[-1]),
                            p["router"]).astype(jnp.float32)
        jax.debug.callback(lambda idx: recorded.append(np.array(idx)),
                           jax.lax.top_k(logits, cfg.top_k)[1])
        return block(x, p, cfg)

    jax_transformer.moe_block = recording
    try:
        ref = P.run_jax(arch, mode, cut=CUTS[arch], seq=SEQ.get(arch), steps=STEPS)
    finally:
        jax_transformer.moe_block = block
    picks, top_k, count = iter(recorded), moe.top_k, {"parted": 0, "picked": 0}

    def replaying(logits, k):
        _, own = top_k(logits, k)
        want = torch.from_numpy(next(picks)).long()
        count["parted"] += int((own.sort(-1).values != want.sort(-1).values).any(-1).sum())
        count["picked"] += own.shape[0]
        return logits.gather(-1, want), want

    moe.top_k = replaying
    try:
        port = P.run_port(arch, mode, ref, CUTS[arch])
    finally:
        moe.top_k = top_k
    assert next(picks, None) is None, "the port dispatched fewer groups than JAX"
    return ref, port, count


@pytest.fixture(scope="module")
def runs():
    made, routed = P.Runs(), {}

    def run(arch, mode):
        if P.configs(arch, CUTS[arch])[1].family == "moe" and mode.startswith("bf16"):
            if (arch, mode) not in routed:
                routed[(arch, mode)] = routed_runs(arch, mode)
            return routed[(arch, mode)][:2]
        return made(arch, mode, CUTS[arch], SEQ.get(arch), STEPS)

    run.routed = routed
    return run


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode, runs):
    P.check_forward(arch, mode, *runs(arch, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, mode, runs):
    P.check_prefill(arch, mode, *runs(arch, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, mode, runs):
    P.check_decode(arch, mode, *runs(arch, mode))


def test_full_configs_keep_their_widths():
    """The cut changes depth, vocabulary, frames, vision tokens (and
    qwen2.5-32b's d_ff) only, in both packages alike."""
    for arch, cut in CUTS.items():
        jcfg, cfg = P.configs(arch, cut)
        for field in ("d_model", "n_heads", "n_kv_heads", "head_dim_", "qk_norm", "n_experts",
                      "top_k", "capacity_factor", "mrope_sections", "family"):
            assert getattr(cfg, field) == getattr(get_config(arch), field), (arch, field)
            assert getattr(cfg, field) == getattr(jcfg, field), (arch, field)


def test_moe_capacity_drops_assignments(runs, monkeypatch):
    """The port's prefill of the compared MoE case, its dispatch watched:
    some expert gets more assignments than its capacity in some layer, so
    the parity tests above compared dropped assignments."""
    arch = "granite-moe-1b-a400m"
    ref, _ = runs(arch, "f32-tempered")
    seen = []
    dispatch = moe._dispatch_one_group

    def watched(xf, router, w_gate, w_up, w_down, cfg, C, first_expert=0):
        sel = moe.top_k(dot(xf, router).float(), cfg.top_k)[1]
        counts = torch.bincount(sel.reshape(-1), minlength=cfg.n_experts)
        seen.append((xf.shape[0], C, int((counts - C).clamp_min(0).sum())))
        return dispatch(xf, router, w_gate, w_up, w_down, cfg, C, first_expert)

    monkeypatch.setattr(moe, "_dispatch_one_group", watched)
    P.run_port(arch, "f32-tempered", ref, CUTS[arch])
    prefill = [dropped for tokens, _, dropped in seen if tokens >= 256]
    assert prefill and sum(prefill) > 0, seen


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "qwen2.5-32b"])
def test_train_step_matches_jax(arch):
    check_train_step_matches_jax(arch, cut=CUTS[arch], steps=1,
                                 seq=TRAIN_SEQ.get(arch, 32), mode="f32-tempered")


def test_moe_bf16_replays_jax_routing(runs):
    """The bf16 MoE case ran on JAX's picks, and the port's own picks
    differed from them only at near-ties: in a few tokens."""
    arch, mode = "granite-moe-1b-a400m", "bf16-tempered"
    runs(arch, mode)
    count = runs.routed[(arch, mode)][2]
    assert count["picked"] > 0 and count["parted"] <= 0.01 * count["picked"], count
