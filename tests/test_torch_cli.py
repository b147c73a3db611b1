"""Port parity, the command line (``python -m mustafar_tpu_torch``).

(a) ``_build_engine``'s mode-to-cache table (as ``tests/test_cli.py``) and
    the ``eval`` subcommand, against the JAX CLI's.
(b) ``synth-ckpt --small --rows 2``: the config, the index json, the
    tokenizer files and the passkey rows equal to the JAX writer's, every
    tensor bit-equal (the same draws rounded to bf16 by torch).
(c) ``harness.tokenizer.LocalTokenizer`` against ``AutoTokenizer`` (in this
    test only) on that checkpoint: ids with and without special tokens,
    decoded text, the EOS and BOS ids; with a BOS-adding post-processor (a
    Llama-3 tokenizer's) and a chat template written here, rendered by both.
(d) ``predict`` under ``MUSTAFAR_CPU=1`` on the checkpoint the JAX package
    wrote: q8q4 at 0.7 with ``--weights int8``, and with ``int8-a8
    --fuse_proj`` on a copy named as a Llama-3 instruct model (the chat
    template wraps the prompt): the prediction jsonl equal to the JAX CLI's,
    or parted only after a near-tie; then ``eval``.  ``--help`` lists the
    four subcommands; the port's default output directories are its own,
    never the JAX package's recorded ``pred/`` and ``accuracy/``.
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mustafar_tpu import cli as jcli
from mustafar_tpu import config as jc
from mustafar_tpu_torch import cli as tcli
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.harness.tokenizer import LocalTokenizer

from test_torch_tinylm import TIE_TOL, _teacher_forced_gap

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] not in ['system', 'user', 'assistant'] %}"
    "{{ raise_exception('unknown role') }}{% endif %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] | trim }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n"
    "{% endif %}{# {{ messages | tojson }} #}")


def _args(**kw):
    ns = argparse.Namespace(mode="kt_mag_vt_mag", cache=None, k_sparsity=0.7,
                            v_sparsity=0.7, group_size=32, residual_length=32,
                            max_seq_len=4608, dtype="bfloat16")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("kw", [
    {}, {"mode": "kt_mag_vc_mag"}, {"mode": "dense"}, {"cache": "masked"},
    {"mode": "kt_opa_vt_mag"}, {"mode": "think"},
    {"codec": "q8q4", "chunked_prefill": True, "max_seq_len": 2048},
    {"mode": "kt_mag_vt_mag", "cache": "dense", "k_sparsity": 0.5, "group_size": 16}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_build_engine_table_equal(kw):
    j = jcli._build_engine(_args(**kw), jc.TINY_LLAMA)
    t = tcli._build_engine(_args(**kw), tc.TINY_LLAMA)
    assert t.cache_mode.value == j.cache_mode.value
    assert (t.prune.method.value, t.prune.k_sparsity, t.prune.v_sparsity,
            t.prune.group_size, t.prune.residual_length) == (
        j.prune.method.value, j.prune.k_sparsity, j.prune.v_sparsity,
        j.prune.group_size, j.prune.residual_length)
    assert (t.max_seq_len, t.chunked_prefill, t.codec) == (
        j.max_seq_len, j.chunked_prefill, j.codec)


def test_eval_subcommand_equal(tmp_path, capsys):
    recs = {"passage_count": [("the answer is 5", "5", 1000), ("4 or 5", "5", 9000)],
            "passage_retrieval_en": [("Paragraph 3", "Paragraph 4", 5000),
                                     ("Paragraph 4", "Paragraph 4", 100)]}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        for task, rs in recs.items():
            with open(tmp_path / pkg / f"{task}.jsonl", "w") as f:
                for pred, ans, length in rs:
                    f.write(json.dumps({"pred": pred, "answers": [ans],
                                        "all_classes": None, "length": length}) + "\n")
    outs = []
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        for e in ([], ["--e"]):
            cli.main(["eval", "--pred_dir", str(tmp_path / pkg), *e])
            outs.append(json.loads(capsys.readouterr().out))
    assert outs[2:] == outs[:2]
    assert outs[0] == {"passage_count": 75.0, "passage_retrieval_en": 50.0}


def test_help_lists_the_subcommands():
    proc = subprocess.run([sys.executable, "-m", "mustafar_tpu_torch", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for cmd in ("predict", "eval", "synth-ckpt", "accuracy", "MUSTAFAR_CPU", "bench",
                "train-tiny"):
        assert cmd in proc.stdout


def test_default_outputs_leave_the_recorded_grids(monkeypatch):
    seen = {}
    monkeypatch.setattr(tcli, "cmd_accuracy", lambda a: seen.update(accuracy=a.out))
    monkeypatch.setattr(tcli, "cmd_predict", lambda a: seen.update(predict=a.out_root))
    tcli.main(["accuracy"])
    tcli.main(["predict", "--model", "unused"])
    assert seen == {"accuracy": "accuracy_torch", "predict": "pred_torch"}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    args = ["--small", "--rows", "2", "--ctx", "600"]
    jcli.main(["synth-ckpt", "--out", str(root / "jax"), *args])
    tcli.main(["synth-ckpt", "--out", str(root / "port"), *args])
    return root / "jax", root / "port"


def test_synth_ckpt_equal(ckpts):
    from safetensors.numpy import load_file
    jdir, tdir = ckpts
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in ("config.json", "model.safetensors.index.json", "tokenizer_config.json",
                 "tokenizer.json"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert (tdir / "rows" / "passkey.jsonl").read_text() == \
        (jdir / "rows" / "passkey.jsonl").read_text()
    shards = sorted(n for n in names if n.endswith(".safetensors"))
    assert shards == ["model-00001-of-00001.safetensors"]
    n_tensors = 0
    for shard in shards:
        want, got = load_file(str(jdir / shard)), load_file(str(tdir / shard))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
            n_tensors += 1
    assert n_tensors == 3 + 2 * 9


TEXTS = ["The pass key is 48213. Remember it.", "  leading spaces\tand tabs\n\n",
         "会议讨论了生产和销售。", "def f(x):\n    return x  # don't", "",
         "<|begin_of_text|>special in text<|end_of_text|>", "naïve café – 𝔘𝔫𝔦𝔠𝔬𝔡𝔢",
         "Hello , world . Is n't it ? I 'm sure , they 're ' here ' !"]


def _with_post_processor(src, dst):
    """A copy of the checkpoint whose tokenizer adds BOS (Llama-3's
    TemplateProcessing), carries CHAT_TEMPLATE and cleans up spaces on
    decode, as a Llama-3 instruct directory does."""
    from tokenizers import Tokenizer, processors
    shutil.copytree(src, dst)
    tok = Tokenizer.from_file(str(dst / "tokenizer.json"))
    bos = "<|begin_of_text|>"
    tok.post_processor = processors.TemplateProcessing(
        single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
        special_tokens=[(bos, tok.token_to_id(bos))])
    tok.save(str(dst / "tokenizer.json"))
    cfg = json.loads((dst / "tokenizer_config.json").read_text())
    cfg["chat_template"] = CHAT_TEMPLATE
    cfg["clean_up_tokenization_spaces"] = True     # as Llama-3's config sets it
    (dst / "tokenizer_config.json").write_text(json.dumps(cfg, indent=1))
    return dst


def test_tokenizer_matches_auto_tokenizer(ckpts, tmp_path):
    from transformers import AutoTokenizer
    jdir, _ = ckpts
    for path in (jdir, _with_post_processor(jdir, tmp_path / "Meta-Llama-3-8B-Instruct")):
        auto, local = AutoTokenizer.from_pretrained(str(path)), LocalTokenizer(str(path))
        assert (local.eos_token_id, local.bos_token_id) == (auto.eos_token_id,
                                                            auto.bos_token_id)
        for text in TEXTS:
            ids = auto(text, truncation=False, return_tensors="np").input_ids
            np.testing.assert_array_equal(local(text, truncation=False,
                                                return_tensors="np").input_ids, ids)
            assert local.encode(text, add_special_tokens=False) == auto.encode(
                text, add_special_tokens=False)
            for skip in (True, False):
                assert local.decode(ids[0], skip_special_tokens=skip) == auto.decode(
                    ids[0], skip_special_tokens=skip)
        if path != jdir:
            assert ids[0, 0] == auto.bos_token_id       # the post-processor's BOS
            msgs = [{"role": "user", "content": "  Where is the pass key?  "}]
            for gen_prompt in (True, False):
                assert local.apply_chat_template(
                    msgs, tokenize=False, add_generation_prompt=gen_prompt) == \
                    auto.apply_chat_template(msgs, tokenize=False,
                                             add_generation_prompt=gen_prompt)
            bad = [{"role": "tool", "content": "x"}]
            with pytest.raises(Exception, match="unknown role"):
                local.apply_chat_template(bad, tokenize=False)


def _predict(cli, model, rows, out_root, extra):
    cli.main(["predict", "--model", str(model), "--datasets", "passkey",
              "--data_dir", str(rows), "--mode", "kt_mag_vt_mag", "--codec", "q8q4",
              "--k_sparsity", "0.7", "--v_sparsity", "0.7", "--max_length", "512",
              "--max_seq_len", "1024", "--limit", "2", "--out_root", str(out_root),
              *extra])
    run, = glob.glob(os.path.join(out_root, "*"))
    return run, [json.loads(line) for line in open(os.path.join(run, "passkey.jsonl"))]


@pytest.mark.parametrize("weights", [["--weights", "int8"],
                                     ["--weights", "int8-a8", "--fuse_proj"]],
                         ids=["int8", "int8-a8-fused"])
def test_predict_matches_jax_cli(ckpts, tmp_path, monkeypatch, capsys, weights):
    from mustafar_tpu_torch.harness import configs
    from mustafar_tpu_torch.harness.longbench import build_chat, truncate_middle
    from mustafar_tpu_torch.models import quant
    from mustafar_tpu_torch.models.weights import load_hf_dir
    from mustafar_tpu_torch.runtime.generate import Generator

    monkeypatch.setenv("MUSTAFAR_CPU", "1")
    jdir, _ = ckpts
    model = jdir
    if "--fuse_proj" in weights:         # a chat model: the template wraps prompts
        model = _with_post_processor(jdir, tmp_path / "Meta-Llama-3-8B-Instruct")
    rows = jdir / "rows"
    jrun, want = _predict(jcli, model, rows, tmp_path / "jax", weights)
    trun, got = _predict(tcli, model, rows, tmp_path / "port", weights)
    assert os.path.basename(trun) == os.path.basename(jrun)
    assert len(got) == len(want) == 2
    tok = LocalTokenizer(str(model))
    gen = None
    for row, jrec, trec in zip(map(json.loads, open(rows / "passkey.jsonl")), want, got):
        assert (trec["answers"], trec["length"]) == (jrec["answers"], jrec["length"])
        if trec == jrec:
            continue
        if gen is None:                  # the port's engine, as predict built it
            cfg, params = load_hf_dir(str(model), dtype=torch.bfloat16, device="cpu")
            params = quant.quantize_params(params)
            if "int8-a8" in weights:
                params = quant.fuse_projections(quant.enable_act_quant(params))
            gen = Generator(tcli._build_engine(_args(codec="q8q4", max_seq_len=1024),
                                               cfg), params, device="cpu")
        prompt = truncate_middle(tok, configs.DATASET2PROMPT["passkey"].format(
            context=row["context"], input=""), 512)
        prompt = build_chat(tok, prompt, os.path.basename(str(model)))
        js = tok.encode(jrec["pred"], add_special_tokens=False)
        ts = tok.encode(trec["pred"], add_special_tokens=False)
        k = next((i for i, (a, b) in enumerate(zip(js, ts)) if a != b), min(len(js), len(ts)))
        stream = js[:k + 1] if k < len(js) else js + [tok.eos_token_id]
        gaps = _teacher_forced_gap(gen, tok(prompt, return_tensors="np").input_ids, stream)
        assert gaps.max() <= TIE_TOL, (jrec["pred"], trec["pred"], gaps)
    capsys.readouterr()
    tcli.main(["eval", "--pred_dir", trun])
    assert "passkey" in json.loads(capsys.readouterr().out)
    assert "passkey" in json.load(open(os.path.join(trun, "result.json")))
