"""LongBench prediction + scoring harness: the port's
``mustafar_tpu/harness/longbench.py``.

The reference's evaluation flow:
  * prediction: pred_long_bench.py (prompt templating :215-228, middle-out
    truncation :54-62, chat wrapping :20-40,64, greedy generation :75-82,
    per-task jsonl output :229-232);
  * scoring: eval_long_bench.py (scorer :66-75 / scorer_e :48-64, per-task
    metric dispatch :18-40, result.json :104-109).

Generation runs through the port's ``Generator`` (``runtime/generate.py``)
on its device.  Dataset rows come from a local directory of ``<task>.jsonl``
files only: nothing is downloaded (the JAX package falls back to the HF
datasets cache; the port does not).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from mustafar_tpu_torch.harness import configs
from mustafar_tpu_torch.harness.metrics import DATASET2METRIC


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def build_chat(tokenizer, prompt: str, model_name: str) -> str:
    """Chat-template wrapping for instruct models (pred_long_bench.py:20-40).

    Matches the reference's model matching exactly: llama-3 instruct and
    mistral-v0.2-instruct only (NOT any mistral-instruct).  The reference's
    longchat/fastchat branch is out of scope (not in its tested model grid,
    README.md:113-122)."""
    name = model_name.lower()
    if ("llama-3" in name and "instruct" in name) or "mistral-v0.2-instruct" in name:
        messages = [{"role": "user", "content": prompt}]
        return tokenizer.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
    return prompt


def post_process(response: str, model_name: str) -> str:
    if "xgen" in model_name:
        return response.strip().replace("Assistant:", "")
    if "internlm" in model_name:
        return response.split("<eoa>")[0]
    return response


def truncate_middle(tokenizer, prompt: str, max_length: int) -> str:
    """Middle-out truncation to the per-model token cap (pred_long_bench.py:54-59)."""
    ids = tokenizer(prompt, truncation=False, return_tensors="np").input_ids[0]
    if len(ids) <= max_length:
        return prompt
    half = int(max_length / 2)
    return (tokenizer.decode(ids[:half], skip_special_tokens=True)
            + tokenizer.decode(ids[-half:], skip_special_tokens=True))


@dataclass
class PredictConfig:
    model_name: str = "tiny-llama"
    max_length: int = 4096          # model2maxlen cap
    out_dir: str = "pred"


def predict_dataset(generator, tokenizer, dataset: str, rows: Iterable[dict],
                    cfg: PredictConfig, eos_id: Optional[int] = None,
                    progress: bool = True):
    """Run greedy predictions for one LongBench task.

    rows: dicts with context/input/answers/all_classes/length fields
    (the THUDM/LongBench schema).  Returns the list of prediction records and
    writes `<out_dir>/<dataset>.jsonl` (reference pred_long_bench.py:229-232).
    """
    prompt_format = configs.DATASET2PROMPT[dataset]
    max_gen = configs.DATASET2MAXLEN[dataset]
    preds = []
    it = rows
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(rows, desc=dataset)
        except ImportError:
            pass
    for row in it:
        prompt = prompt_format.format(context=row.get("context", ""),
                                      input=row.get("input", ""))
        prompt = truncate_middle(tokenizer, prompt, cfg.max_length)
        if dataset not in configs.NO_CHAT_DATASETS:
            prompt = build_chat(tokenizer, prompt, cfg.model_name)
        ids = tokenizer(prompt, truncation=False, return_tensors="np").input_ids
        if dataset == "samsum" and eos_id is not None:
            # reference special case (pred_long_bench.py:64-74): also stop on
            # newline, and force at least one non-EOS token (min_length=ctx+1)
            nl = tokenizer.encode("\n", add_special_tokens=False)[-1]
            out_ids = generator.generate(ids, max_new_tokens=max_gen,
                                         eos_id=(eos_id, nl),
                                         min_new_tokens=1)[0]
        else:
            out_ids = generator.generate(ids, max_new_tokens=max_gen,
                                         eos_id=eos_id)[0]
        pred = tokenizer.decode(np.asarray(out_ids), skip_special_tokens=True)
        pred = post_process(pred, cfg.model_name)
        preds.append({"pred": pred, "answers": row.get("answers"),
                      "all_classes": row.get("all_classes"),
                      "length": row.get("length")})
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, f"{dataset}.jsonl"), "w",
              encoding="utf-8") as f:
        for p in preds:
            f.write(json.dumps(p, ensure_ascii=False) + "\n")
    return preds


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

_FIRSTLINE_DATASETS = {"trec", "triviaqa", "samsum", "lsht"}


def scorer(dataset: str, predictions, answers, all_classes) -> float:
    """Mean best-over-ground-truths score x100 (eval_long_bench.py:66-75)."""
    metric = DATASET2METRIC[dataset]
    total = 0.0
    for prediction, ground_truths in zip(predictions, answers):
        if not ground_truths:
            # the reference's bare max() would throw here too
            # (eval_long_bench.py:72) — an empty ground-truth list is
            # malformed data, not a zero score
            raise ValueError(f"{dataset}: row with empty ground-truth list")
        if dataset in _FIRSTLINE_DATASETS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        total += max(metric(prediction, gt, all_classes=all_classes)
                     for gt in ground_truths)
    return round(100 * total / len(predictions), 2)


def scorer_e(dataset: str, predictions, answers, lengths, all_classes) -> dict:
    """Length-bucketed scorer for LongBench-E (eval_long_bench.py:48-64)."""
    metric = DATASET2METRIC[dataset]
    buckets = {"0-4k": [], "4-8k": [], "8k+": []}
    for prediction, ground_truths, length in zip(predictions, answers, lengths):
        if not ground_truths:
            raise ValueError(f"{dataset}: row with empty ground-truth list")
        if dataset in _FIRSTLINE_DATASETS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        score = max(metric(prediction, gt, all_classes=all_classes)
                    for gt in ground_truths)
        key = "0-4k" if length < 4000 else ("4-8k" if length < 8000 else "8k+")
        buckets[key].append(score)
    return {k: round(100 * float(np.mean(v)), 2) if v else 0.0
            for k, v in buckets.items()}


def evaluate_dir(path: str, e_buckets: bool = False) -> dict:
    """Score every <task>.jsonl under path; writes result.json
    (eval_long_bench.py:78-109)."""
    scores = {}
    for filename in sorted(os.listdir(path)):
        if not filename.endswith(".jsonl"):
            continue
        dataset = filename.split(".")[0]
        predictions, answers, lengths, all_classes = [], [], [], None
        with open(os.path.join(path, filename), encoding="utf-8") as f:
            for line in f:
                rec = json.loads(line)
                predictions.append(rec["pred"])
                answers.append(rec["answers"])
                all_classes = rec.get("all_classes")
                if rec.get("length") is not None:
                    lengths.append(rec["length"])
        if e_buckets:
            scores[dataset] = scorer_e(dataset, predictions, answers, lengths,
                                       all_classes)
        else:
            scores[dataset] = scorer(dataset, predictions, answers, all_classes)
    with open(os.path.join(path, "result.json"), "w") as f:
        json.dump(scores, f, ensure_ascii=False, indent=4)
    return scores


def load_longbench_rows(dataset: str, data_dir: Optional[str] = None,
                        e_split: bool = False):
    """LongBench task rows from ``<data_dir>/<dataset>.jsonl`` (the THUDM
    schema; a LongBench-E run, ``e_split``, reads the same file, as the JAX
    package does given a ``data_dir``).  Without ``data_dir`` it raises: the
    port reads local files only."""
    if not data_dir:
        raise ValueError(
            f"{dataset}: no data_dir; the port reads LongBench rows from local "
            f"<data_dir>/<task>.jsonl files only (e.g. rows written by "
            f"harness.longbench_synth or synth-ckpt --rows)")
    p = os.path.join(data_dir, f"{dataset}.jsonl")
    with open(p, encoding="utf-8") as f:
        return [json.loads(line) for line in f]
