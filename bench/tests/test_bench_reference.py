"""The plain references against the port's plain route, on the CPU, at the
SMOKE sizes of the two configurations, in float32: each reference's loss
and gradients (training) and its logits after prefill and decode
(serving), whichever cell of the benchmark uses it today, so that a later
cell of either kind on either configuration needs no new reference; and
the chunked scan against the port's plain scan."""
import pytest
import torch

from harness import weights
from harness.family import sizes as reference_sizes
from harness.train import model_config

from conftest import FLOAT32, SERVE, TRAIN, small_cell


def tree_f32(tree):
    if isinstance(tree, dict):
        return {k: tree_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_f32(v) for v in tree]
    return tree.float().clone()


def test_moe_loss_and_gradients_match_the_ports_plain_route():
    from repro_torch.models import train_loss
    from reference import moe_lm, training
    from reference.common import F32

    cell = small_cell(TRAIN, FLOAT32)
    cfg = model_config(cell.config, cell.job)
    params = weights.draw(cell.config, 7, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size - 1, (2, 32), generator=gen)
    targets = torch.randint(0, cfg.vocab_size - 1, (2, 32), generator=gen)
    named = weights.leaves_of(params)
    for _, t in named:
        t.requires_grad_(True)
    batch = {"tokens": tokens.int(), "targets": targets.int()}
    ours = train_loss(params, batch, cfg)
    g_ours = torch.autograd.grad(ours, [t for _, t in named])
    ref_params = tree_f32(params)
    ref_named = training.leaves_of(ref_params)
    assert [n for n, _ in ref_named] == [n for n, _ in named]
    for _, t in ref_named:
        t.requires_grad_(True)
    ref = moe_lm.loss(ref_params, tokens, targets, reference_sizes(cell.config), F32)
    g_ref = torch.autograd.grad(ref, [t for _, t in ref_named])
    assert float(ours.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for (name, _), a, b in zip(named, g_ours, g_ref):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6), name


def test_moe_capacity_drops_the_late_assignments():
    """At a capacity below the load, the reference keeps each expert's first
    assignments in (token, rank) order, as the port's dispatch does."""
    from repro_torch.models.moe import moe_block
    from reference import moe_lm
    from reference.common import F32

    cell = small_cell(TRAIN, FLOAT32)
    cell.config["model"]["capacity_factor"] = 0.25
    cfg = model_config(cell.config, cell.job)
    params = weights.draw(cell.config, 11, torch.device("cpu"))
    h = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(5))
    p = params["layers"][0]["moe"]
    ours, aux = moe_block(h, p, cfg)
    ref, ref_aux = moe_lm.moe(h, p, reference_sizes(cell.config), F32)
    assert torch.allclose(ours, ref, rtol=1e-4, atol=1e-6)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)


def test_mamba_logits_after_prefill_and_decode_match_the_ports_plain_route():
    from repro_torch.models.spec import build_params
    from reference import mamba_lm
    from reference.common import F32

    cell = small_cell(SERVE, FLOAT32)
    cfg = model_config(cell.config, cell.job)
    tree = weights.draw(cell.config, 9, torch.device("cpu"))
    got, seq = served_logits(build_params(tree), cfg, 40, 3, 1)
    ref = mamba_lm.logits_at(tree, reference_sizes(cell.config), [seq], [torch.arange(39, 43)],
                             F32)[0]
    # the port keeps the decode's conv window in bf16: decode rows are a bf16 step off
    assert torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    for i in range(1, 4):
        assert torch.allclose(got[i], ref[i], rtol=0, atol=5e-2)


def served_logits(params, cfg, prompt_len: int, steps: int, seed: int):
    """The port's logits of one prompt's prefill and ``steps`` greedy decode
    steps, and the whole sequence of ids."""
    from repro_torch.models import decode_fn, prefill_fn

    prompt = torch.randint(0, cfg.vocab_size - 1, (1, prompt_len),
                           generator=torch.Generator().manual_seed(seed))
    logits, cache = prefill_fn(params, {"tokens": prompt.int()}, cfg,
                               capacity=prompt_len + steps + 1)
    got = [logits[0]]
    seq = prompt[0].tolist()
    for _ in range(steps):
        tok = int(got[-1].argmax())
        seq.append(tok)
        logits, cache = decode_fn(params, {"tokens": torch.tensor([[tok]], dtype=torch.int32)},
                                  cache, cfg)
        got.append(logits[0])
    return got, torch.tensor(seq)


def test_moe_logits_after_prefill_and_decode_match_the_ports_plain_route():
    from repro_torch.models.spec import build_params
    from reference import moe_lm
    from reference.common import F32

    cell = small_cell(TRAIN, FLOAT32)
    cfg = model_config(cell.config, cell.job)
    tree = weights.draw(cell.config, 13, torch.device("cpu"))
    got, seq = served_logits(build_params(tree), cfg, 40, 3, 2)
    ref = moe_lm.logits_at(tree, reference_sizes(cell.config), [seq], [torch.arange(39, 43)],
                           F32)[0]
    assert torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    # the port keeps the KV cache in bf16: decode rows are a bf16 rounding of k, v off
    for i in range(1, 4):
        assert torch.allclose(got[i], ref[i], rtol=0, atol=2e-3), i


def test_mamba_loss_and_gradients_match_the_ports_plain_route():
    from repro_torch.models import train_loss
    from reference import mamba_lm, training
    from reference.common import F32

    cell = small_cell(SERVE, FLOAT32)
    cfg = model_config(cell.config, cell.job)
    params = weights.draw(cell.config, 5, torch.device("cpu"))
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size - 1, (2, 24), generator=gen)
    targets = torch.randint(0, cfg.vocab_size - 1, (2, 24), generator=gen)
    named = weights.leaves_of(params)
    for _, t in named:
        t.requires_grad_(True)
    ours = train_loss(params, {"tokens": tokens.int(), "targets": targets.int()}, cfg)
    g_ours = torch.autograd.grad(ours, [t for _, t in named])
    ref_params = tree_f32(params)
    ref_named = training.leaves_of(ref_params)
    assert [n for n, _ in ref_named] == [n for n, _ in named]
    for _, t in ref_named:
        t.requires_grad_(True)
    ref = mamba_lm.loss(ref_params, tokens, targets, reference_sizes(cell.config), F32)
    g_ref = torch.autograd.grad(ref, [t for _, t in ref_named])
    assert float(ours.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for (name, _), a, b in zip(named, g_ours, g_ref):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6), name


@pytest.mark.parametrize("S,block", [(1, 1024), (37, 16), (100, 32), (130, 1024)])
def test_chunked_scan_matches_the_ports_plain_scan(S, block, monkeypatch):
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_plain
    from reference import mamba_lm

    monkeypatch.setattr(mamba_lm, "BLOCK", block)
    g = torch.Generator().manual_seed(S)
    D, N = 24, 4
    x = torch.randn(S, D, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(S, D, generator=g))
    A = -torch.exp(0.5 * torch.randn(D, N, generator=g))
    B, C = torch.randn(S, N, generator=g), torch.randn(S, N, generator=g)
    want = ssm_scan_plain(x[None].double(), dt[None].double(), A.double(), B[None].double(),
                          C[None].double(), torch.zeros(D, dtype=torch.float64))[0]
    got = mamba_lm.scan(x, dt, A, B, C)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("decay", [15.0, 30.0, 200.0])
def test_chunked_scan_is_exact_where_a_step_decays_steeply(decay):
    """Steps that decay by 15, 30 or 200 (past the clamp at 20, whose
    carried-over term lies under float32's rounding) match the exact loop;
    every exp stays finite."""
    from reference import mamba_lm

    g = torch.Generator().manual_seed(0)
    S, D, N = 40, 8, 4
    x = torch.randn(S, D, generator=g)
    dt = torch.full((S, D), decay)
    dt[::3] = 0.01  # slow steps between steep ones carry the state
    A = -torch.ones(D, N)
    B, C = torch.randn(S, N, generator=g), torch.randn(S, N, generator=g)
    got = mamba_lm.scan(x, dt, A, B, C)
    want, _ = mamba_lm.scan_steps(x, dt, A, B, C, torch.zeros(D, N))
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
