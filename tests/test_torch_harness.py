"""Port parity, the LongBench harness's plain-Python modules.

(a) ``harness/configs.py``: every table and ``model_max_len`` equal to the
    JAX package's.
(b) ``harness/metrics.py``: every ``DATASET2METRIC`` entry (``passkey``
    too) equal over a fixed table of English and Chinese predictions and
    ground truths, with the optional ``rouge`` / ``jieba`` imports as
    installed and with both made unimportable (the fallbacks the card's
    machine runs).
(c) ``harness/longbench_synth.py`` ``make_task_rows`` for all 22 tasks,
    ``tinylm.make_passkey_row`` and ``ByteTokenizer``, over a fixed corpus
    string: equal rows, ids and text.
(d) ``tinylm._engine`` over every mode of its grammar's examples (and an
    unknown flag, refused by both): the same ``EngineConfig`` fields, enums
    by value.
(e) ``harness/longbench.py``: ``truncate_middle``, ``build_chat``,
    ``post_process``, ``scorer``, ``scorer_e`` and ``evaluate_dir`` on a
    fixture directory; ``load_longbench_rows`` reads a local directory and,
    without one, raises (the port downloads nothing).
"""

import json
import shutil
import sys

import numpy as np
import pytest

from mustafar_tpu.harness import configs as jcfg
from mustafar_tpu.harness import longbench as jlb
from mustafar_tpu.harness import longbench_synth as jsyn
from mustafar_tpu.harness import metrics as jm
from mustafar_tpu.harness import tinylm as jtiny
from mustafar_tpu_torch.harness import configs as tcfg
from mustafar_tpu_torch.harness import longbench as tlb
from mustafar_tpu_torch.harness import longbench_synth as tsyn
from mustafar_tpu_torch.harness import metrics as tm
from mustafar_tpu_torch.harness import tinylm as ttiny

# a fixed corpus: ASCII prose and code, a few thousand lines
CORPUS = "\n".join(
    f"def f{i}(x):\n    # line {i}: the quick brown fox jumps over {i % 7} lazy dogs\n"
    f"    return x * {i} + {i % 13}\n" for i in range(3000))


def test_config_tables_equal():
    for name in ("DATASETS", "DATASETS_EN", "NO_CHAT_DATASETS", "DATASET2PROMPT",
                 "DATASET2MAXLEN", "MODEL2MAXLEN"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for model in ("Llama-2-7b-hf", "meta/Meta-Llama-3-8B-Instruct", "Mistral-7B-v0.1",
                  "Meta-Llama-3-8B", "tiny-acc", "x/Mistral-7B-Instruct-v0.2"):
        assert tcfg.model_max_len(model) == jcfg.model_max_len(model)
        assert tcfg.model_max_len(model, 123) == jcfg.model_max_len(model, 123)


PAIRS = [
    ("The answer is Paragraph 3.", "Paragraph 3"),
    ("Paragraph 12 or 3", "Paragraph 3"),
    ("the cat sat on the mat", "a cat sat on a mat"),
    ("There are 5 unique paragraphs, maybe 6", "5"),
    ("    return x * 3 + 1\n# done", "return x * 3 + 1"),
    ("Human being\nLocation", "Human being"),
    ("Location and Numeric value", "Location"),
    ("", "Sylvania"),
    ("Sylvania!", "Sylvania"),
    ("The capital of Freedonia is Osterlich, an old city.", "Osterlich"),
    ("The report reviews recent progress and outlines next steps for the team.",
     "The report reviews recent progress and outlines next steps."),
    ("会议讨论了生产和销售的工作进展。", "会议讨论了生产、销售、财务、技术与人事等方面的工作进展。"),
    ("段落4", "段落4"),
    ("答案是段落2或段落5", "段落5"),
    ("类别：体育", "体育"),
    ("经济和科技", "科技"),
    ("西尔瓦尼亚", "西尔瓦尼亚"),
    (" 48213. Remember it.", "48213"),
    ("4821", "48213"),
    ("no digits here", "00000"),
]
CLASSES = {"trec": jsyn._TREC_CLASSES, "lsht": jsyn._LSHT_CLASSES}


def _metric_table(metric_map, dataset):
    """Each pair's score, or the exception's type where the metric raises
    (the retrieval metrics on a ground truth without a paragraph number)."""
    metric = metric_map[dataset]
    classes = CLASSES.get(dataset, ["Human being", "Location", "Numeric value", "体育",
                                    "经济", "科技"])
    out = []
    for p, g in PAIRS:
        try:
            out.append(metric(p, g, all_classes=classes))
        except IndexError as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("fallback", [False, True], ids=["as-installed", "fallbacks"])
@pytest.mark.parametrize("dataset", sorted(jm.DATASET2METRIC))
def test_metrics_equal(dataset, fallback, monkeypatch):
    assert sorted(tm.DATASET2METRIC) == sorted(jm.DATASET2METRIC)
    if fallback:      # neither optional package importable, as on the card
        monkeypatch.setitem(sys.modules, "rouge", None)
        monkeypatch.setitem(sys.modules, "jieba", None)
    assert _metric_table(tm.DATASET2METRIC, dataset) == _metric_table(jm.DATASET2METRIC,
                                                                     dataset)


def test_passkey_score_and_helpers_equal():
    for p, g in PAIRS:
        assert ttiny.passkey_score(p, g) == jtiny.passkey_score(p, g)
        assert tm.normalize_answer(p) == jm.normalize_answer(p)
        assert tm.normalize_zh_answer(p) == jm.normalize_zh_answer(p)


@pytest.mark.parametrize("task", sorted(jcfg.DATASET2PROMPT))
def test_task_rows_equal(task):
    want = jsyn.make_task_rows(CORPUS, np.random.RandomState(5), task, 3, ctx_bytes=900)
    got = tsyn.make_task_rows(CORPUS, np.random.RandomState(5), task, 3, ctx_bytes=900)
    assert got == want


def test_passkey_rows_and_byte_tokenizer_equal():
    for depth in (None, 0.0, 0.5, 1.0):
        want = jtiny.make_passkey_row(CORPUS, np.random.RandomState(2), 700, depth)
        got = ttiny.make_passkey_row(CORPUS, np.random.RandomState(2), 700, depth)
        assert got == want
    assert (ttiny.VOCAB, ttiny.BOS_ID, ttiny.EOS_ID, ttiny.PASSKEY_QUESTION, ttiny.NEEDLE) == (
        jtiny.VOCAB, jtiny.BOS_ID, jtiny.EOS_ID, jtiny.PASSKEY_QUESTION, jtiny.NEEDLE)
    assert ttiny._CORPUS_ROOTS == jtiny._CORPUS_ROOTS
    jt, tt = jtiny.ByteTokenizer(), ttiny.ByteTokenizer()
    for text in ("The pass key is 48213.", "会议记录：\n", "", "xé퟿"):
        for special in (False, True):
            assert tt.encode(text, special) == jt.encode(text, special)
        np.testing.assert_array_equal(tt(text, return_tensors="np").input_ids,
                                      jt(text, return_tensors="np").input_ids)
        assert tt(text).input_ids == jt(text).input_ids
        ids = [256] + jt.encode(text) + [257, 300]
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode(np.asarray([ids])) == jt.decode(np.asarray([ids]))
    assert (tt.eos_token_id, tt.bos_token_id) == (jt.eos_token_id, jt.bos_token_id)


# the examples of _engine's docstring and more: every codec, methods, flags
MODES = ["dense", "masked", "compressed", "masked:kt_mag_vt_opa",
         "compressed-q8q4:kt_opa_vt_mag+chunked", "compressed-q8q4+r64+c128",
         "compressed-q8", "compressed-q4q4+chunked", "compressed-bitmap-q8",
         "masked:think", "masked:kt_mag_vc_mag+r16", "compressed-q8q4+chunked"]


def _fields(eng):
    p = eng.prune
    return dict(model=eng.model.name, cache_mode=eng.cache_mode.value,
                method=p.method.value, k=p.k_sparsity, v=p.v_sparsity,
                group=p.group_size, residual=p.residual_length, keep=p.exact_keep,
                max_seq=eng.max_seq_len, chunk=eng.chunk_size, bucket=eng.prefill_bucket,
                batch=eng.batch_size, chunked=eng.chunked_prefill, codec=eng.codec)


@pytest.mark.parametrize("mode", MODES)
def test_engine_grammar_equal(mode):
    for s in (0.5, 0.7):
        assert _fields(ttiny._engine(ttiny.TINY_ACC, mode, s, 2048)) == _fields(
            jtiny._engine(jtiny.TINY_ACC, mode, s, 2048))


def test_engine_grammar_refuses_unknown_flag():
    for mod in (jtiny, ttiny):
        with pytest.raises(ValueError, match="unknown grid-mode flag"):
            mod._engine(mod.TINY_ACC, "compressed-q8q4+x7", 0.7, 2048)


class _ChatTok(ttiny.ByteTokenizer):
    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        return f"<user>{messages[0]['content']}</user><assistant>"


def test_prompt_helpers_equal():
    tok = ttiny.ByteTokenizer()
    prompt = jcfg.DATASET2PROMPT["passage_retrieval_en"].format(
        context=CORPUS[:5000], input="an abstract")
    for cap in (100, 4095, 10_000):
        assert tlb.truncate_middle(tok, prompt, cap) == jlb.truncate_middle(tok, prompt, cap)
    for name in ("Meta-Llama-3-8B-Instruct", "Meta-Llama-3-8B", "Mistral-v0.2-Instruct",
                 "tiny-acc"):
        assert tlb.build_chat(_ChatTok(), "hi", name) == jlb.build_chat(_ChatTok(), "hi", name)
    for name in ("xgen-7b", "internlm-7b", "llama"):
        text = " Assistant: yes<eoa> tail"
        assert tlb.post_process(text, name) == jlb.post_process(text, name)
    cfg = tlb.PredictConfig()
    assert (cfg.model_name, cfg.max_length, cfg.out_dir) == ("tiny-llama", 4096, "pred")


def _fixture_dir(path):
    rows = {
        "passkey": [("48213.", ["48213"], None, 1200), (" 00000", ["48213"], None, 5000)],
        "trec": [("Location\nHuman being", ["Location"], jsyn._TREC_CLASSES, 900),
                 ("Numeric value", ["Entity"], jsyn._TREC_CLASSES, 9000)],
        "passage_retrieval_en": [("Paragraph 2", ["Paragraph 2"], None, 3000),
                                 ("1 or 2", ["Paragraph 1"], None, 4100)],
        "qasper": [("the red house", ["blue car", "red house"], None, 100)],
        "vcsum": [("会议讨论了工作", ["会议讨论了生产和销售"], None, 8500)],
    }
    path.mkdir(parents=True, exist_ok=True)
    for task, recs in rows.items():
        with open(path / f"{task}.jsonl", "w", encoding="utf-8") as f:
            for pred, answers, classes, length in recs:
                f.write(json.dumps({"pred": pred, "answers": answers,
                                    "all_classes": classes, "length": length},
                                   ensure_ascii=False) + "\n")
    (path / "notes.txt").write_text("not a prediction file")
    return path


@pytest.mark.parametrize("e_buckets", [False, True], ids=["scorer", "scorer_e"])
def test_evaluate_dir_equal(tmp_path, e_buckets):
    jdir = _fixture_dir(tmp_path / "jax")
    tdir = tmp_path / "port"
    shutil.copytree(jdir, tdir)
    want = jlb.evaluate_dir(str(jdir), e_buckets=e_buckets)
    got = tlb.evaluate_dir(str(tdir), e_buckets=e_buckets)
    assert got == want and sorted(got) == ["passage_retrieval_en", "passkey", "qasper",
                                           "trec", "vcsum"]
    assert (tdir / "result.json").read_text() == (jdir / "result.json").read_text()
    preds, answers = ["cat", "dog", "bird"], [["cat"], ["dog"], ["fish"]]
    assert tlb.scorer("narrativeqa", preds, answers, None) == jlb.scorer(
        "narrativeqa", preds, answers, None)
    assert tlb.scorer_e("narrativeqa", preds, answers, [1000, 5000, 9000], None) == \
        jlb.scorer_e("narrativeqa", preds, answers, [1000, 5000, 9000], None)
    for mod in (jlb, tlb):
        with pytest.raises(ValueError, match="empty ground-truth"):
            mod.scorer("qasper", ["x"], [[]], None)


def test_load_longbench_rows_local_only(tmp_path):
    rows = tsyn.make_task_rows(CORPUS, np.random.RandomState(0), "trec", 3)
    with open(tmp_path / "trec.jsonl", "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    for e_split in (False, True):
        assert tlb.load_longbench_rows("trec", str(tmp_path), e_split) == \
            jlb.load_longbench_rows("trec", str(tmp_path), e_split) == rows
    with pytest.raises(ValueError, match="data_dir"):
        tlb.load_longbench_rows("trec")
