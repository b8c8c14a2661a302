"""BENCHMARK.json keeps the benchmark's rules of form, and a cell, a
configuration and a per-layer metric are found by name from files alone."""
import json
import shutil

from harness import manifest

from conftest import BENCH, SERVE, TRAIN


def test_manifest_keeps_the_rules_of_form():
    m = manifest.load_manifest()
    assert manifest.problems(m) == []
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert [w["name"] for w in m["workloads"]] == [TRAIN, SERVE]
    assert {e["name"] for e in m["end_to_end"]} == {"train_tokens_per_s", "serve_tokens_per_s",
                                                   "setup_s"}
    assert all(w["chips"] == 1 for w in m["workloads"])


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    m = manifest.load_manifest()
    for name in (TRAIN, SERVE):
        cell = manifest.find_cell(name, m)
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(p["moves"] in e2e for p in cell.per_layer)


def test_form_rules_catch_a_bad_name_unit_and_moves():
    m = manifest.load_manifest()
    bad = json.loads(json.dumps(m))
    bad["per_layer"][0]["name"] = "two words"
    bad["per_layer"][1]["unit"] = "tokens per s"
    bad["per_layer"][2]["moves"] = "serve_tokens_per_s"  # a metric of the train cell
    found = manifest.problems(bad)
    assert any("two words" in p for p in found)
    assert any("tokens per s" in p for p in found)
    assert any("lacks serve_tokens_per_s" in p for p in found)


def test_a_cell_added_as_files_and_an_entry_only(tmp_path):
    """A later cell: a job file, a metric's reader and an entry in each list
    of BENCHMARK.json; nothing of the harness changes."""
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    m = manifest.load_manifest()
    new = "granite-moe-1b-a400m.train_8k"
    m["workloads"].append({"name": new, "config": "granite-moe-1b-a400m", "traffic": "train_8k",
                           "chips": 1, "why": "8k sequences"})
    m["end_to_end"][0]["workloads"].append(new)
    m["per_layer"].append({"name": "step_count.train8k", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "autotuner",
                           "moves": "train_tokens_per_s", "workloads": [new]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    job = json.loads((BENCH / "workloads" / f"{TRAIN}.json").read_text())
    job["seq"] = 8192
    (bench / "workloads" / f"{new}.json").write_text(json.dumps(job))
    (bench / "metrics" / "step_count.train8k.py").write_text(
        "def read(run):\n    return float(run.counters['steps'])\n")

    added = manifest.load_manifest(root)
    assert manifest.problems(added, bench) == []
    cell = manifest.find_cell(new, added, bench)
    assert cell.job["seq"] == 8192
    assert cell.config["model"]["n_experts"] == 32
    names = [p["name"] for p in cell.per_layer]
    assert names == ["step_count.train8k"]
    reader = manifest.metric_reader("step_count.train8k", bench)

    class Run:
        counters = {"steps": 7}

    assert reader(Run()) == 7.0


DENSE_LM = '''"""A dense decoder (GQA attention, SwiGLU MLP) in plain float32 PyTorch."""
import torch
import torch.nn.functional as F

from .common import kept, rmsnorm, rope, silu
from .moe_lm import attention


def layout(m):
    d, V, H, KV, hd, ff = (m["d_model"], m["vocab_size"], m["n_heads"], m["n_kv_heads"],
                           m["head_dim"], m["d_ff"])
    leaves = [(("embed",), (V, d)), (("final_norm",), (d,)), (("unembed",), (d, V))]
    for i in range(m["n_layers"]):
        leaves += [(("layers", i, "ln1"), (d,)),
                   (("layers", i, "attn", "wq"), (d, H, hd)),
                   (("layers", i, "attn", "wk"), (d, KV, hd)),
                   (("layers", i, "attn", "wv"), (d, KV, hd)),
                   (("layers", i, "attn", "wo"), (H, hd, d)),
                   (("layers", i, "ln2"), (d,)),
                   (("layers", i, "mlp", "w_gate"), (d, ff)),
                   (("layers", i, "mlp", "w_up"), (d, ff)),
                   (("layers", i, "mlp", "w_down"), (ff, d))]
    return leaves


def forward(params, tokens, m, mm):
    x = params["embed"][tokens].float()
    eps, hd, theta = m["norm_eps"], m["head_dim"], m["rope_theta"]
    for p in params["layers"]:
        B, S, d = x.shape
        a, f = p["attn"], p["mlp"]
        h = rmsnorm(x, p["ln1"], eps)
        q = rope(mm(h, a["wq"].reshape(d, -1)).reshape(B, S, -1, hd), theta)
        k = rope(mm(h, a["wk"].reshape(d, -1)).reshape(B, S, -1, hd), theta)
        v = mm(h, a["wv"].reshape(d, -1)).reshape(B, S, -1, hd)
        x = x + mm(attention(q, k, v, mm).reshape(B, S, -1), a["wo"].reshape(-1, d))
        h = rmsnorm(x, p["ln2"], eps)
        x = x + mm(silu(mm(h, f["w_gate"])) * mm(h, f["w_up"]), f["w_down"])
    return rmsnorm(x, params["final_norm"], eps)


def loss(params, tokens, targets, m, mm):
    logits = mm(forward(params, tokens, m, mm), params["unembed"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())


def logits_at(weights, m, seqs, positions, mm, keep=kept):
    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return [f32(v) for v in t] if isinstance(t, list) else t.float()

    params = f32(weights)
    with torch.no_grad():
        return [mm(forward(params, s[None], m, mm)[0, p], params["unembed"])
                for s, p in zip(seqs, positions)]
'''


def test_a_configuration_of_another_family_added_as_files_only(tmp_path, monkeypatch):
    """A dense decoder, a family no cell runs yet: its configuration file, its
    reference module, a training and a serving job, and entries in
    BENCHMARK.json.  No file the harness has changes, and both cells run on
    the CPU and come out correct."""
    import time

    import torch

    import reference
    from harness import cell as run_cell
    from harness import device as dev

    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = manifest.load_manifest()
    d, ff = 64, 96
    config = {
        "name": "tiny-dense", "source": "https://arxiv.org/abs/2307.09288",
        "reference": "dense_lm",
        "model": dict(name="tiny-dense", family="dense", n_layers=2, d_model=d, n_heads=4,
                      n_kv_heads=2, d_ff=ff, vocab_size=256, rope_theta=10000.0, norm_eps=1e-6,
                      tie_embeddings=False, dtype="float32"),
        "precision": {"params": "float32"},
        "init": dict(embed=0.02, wq=d ** -0.5, wk=d ** -0.5, wv=d ** -0.5, wo=d ** -0.5,
                     w_gate=d ** -0.5, w_up=d ** -0.5, w_down=ff ** -0.5, unembed=d ** -0.5,
                     ln1="ones", ln2="ones", final_norm="ones"),
    }
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(config))
    (bench / "reference" / "dense_lm.py").write_text(DENSE_LM)
    jobs = {"train": json.loads((BENCH / "workloads" / f"{TRAIN}.json").read_text()),
            "serve": json.loads((BENCH / "workloads" / f"{SERVE}.json").read_text())}
    jobs["train"].update(batch=2, seq=32)
    jobs["serve"].update(batch_requests=4, prompt={"law": "log-uniform", "min": 16, "max": 64,
                                                   "multiple": 16},
                         answer={"min": 2, "max": 4}, pool_rows=4, sample={"served_tokens": 8})
    m["configs"].append({"name": "tiny-dense", "source": config["source"],
                         "file": "bench/configs/tiny-dense.json", "reduced": ["num_hidden_layers"],
                         "why": "a dense decoder"})
    for kind, e2e in (("train", 0), ("serve", 1)):
        name = f"tiny-dense.{kind}"
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(jobs[kind]))
        m["workloads"].append({"name": name, "config": "tiny-dense", "traffic": kind, "chips": 1,
                               "why": f"a dense decoder's {kind} path"})
        m["end_to_end"][e2e]["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    added = manifest.load_manifest(root)
    assert manifest.problems(added, bench) == []
    assert all(before[p] == (bench / p).read_bytes() for p in before)
    monkeypatch.setattr(reference, "__path__", [str(bench / "reference")])
    for kind in ("train", "serve"):
        cell = manifest.find_cell(f"tiny-dense.{kind}", added, bench)
        out = run_cell.drive(cell, 4_200_000_001, 0.3, False, time.perf_counter(),
                             torch.device("cpu"), dev.ClockLog(), bench=bench)
        assert out.correct and out.attempted >= 1, (kind, out.checks, out.failed)
