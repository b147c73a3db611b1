"""LongBench metric functions, dependency-light reimplementation: the
port's copy of the JAX package's ``harness/metrics.py``.

Score-compatible with the reference's metrics.py (itself the standard
THUDM/LongBench scorer): qa-F1, rouge-L, classification EM, retrieval,
count, code-sim, plus the zh variants.  Differences from the reference:

* ``fuzz.ratio`` (fuzzywuzzy, not installed here) is implemented via
  difflib.SequenceMatcher — identical to fuzzywuzzy's pure-python fallback
  (fuzzywuzzy uses difflib when python-Levenshtein is absent).
* ``classification_score`` reproduces the reference's *effective* behavior:
  its ``if em_match_list != 0`` branch (metrics.py:98) is always true (list
  vs int), so the difflib fallback is dead code; we implement the live path.
* rouge-L uses the ``rouge`` package when available (exact parity) and an
  LCS-based fallback otherwise; jieba likewise for zh tokenization.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter


def normalize_answer(s: str) -> str:
    """Lower text and remove punctuation, articles and extra whitespace
    (reference metrics.py:12-28)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_CN_PUNCT = ("！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」"
             "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏.")


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


def count_score(prediction: str, ground_truth: str, **kwargs) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def _retrieval(prediction: str, ground_truth: str, pattern: str) -> float:
    gt_id = re.findall(pattern, ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(gt_id))
    return right / len(numbers)


def retrieval_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return _retrieval(prediction, ground_truth, r"Paragraph (\d+)")


def retrieval_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return _retrieval(prediction, ground_truth, r"段落(\d+)")


def _fuzz_ratio(a: str, b: str) -> float:
    """fuzzywuzzy.fuzz.ratio fallback semantics: round(100 * SM.ratio())."""
    if not a and not b:
        return 100.0
    return round(100 * difflib.SequenceMatcher(None, a, b).ratio())


def code_sim_score(prediction: str, ground_truth: str, **kwargs) -> float:
    all_lines = prediction.lstrip("\n").split("\n")
    pred = ""
    for line in all_lines:
        if "`" not in line and "#" not in line and "//" not in line:
            pred = line
            break
    return _fuzz_ratio(pred, ground_truth) / 100


def classification_score(prediction: str, ground_truth: str, **kwargs) -> float:
    all_classes = kwargs["all_classes"]
    matches = [c for c in all_classes if c in prediction]
    # The reference removes proper-substring matches while iterating the list
    # (metrics.py:94-96), which skips the element after each removal; the skip
    # is replicated here so trec/lsht scores are bit-identical.  (Its difflib
    # fallback branch is dead code: `if em_match_list != 0` is always true.)
    i = 0
    while i < len(matches):
        m = matches[i]
        if m in ground_truth and m != ground_truth:
            matches.remove(m)  # next element shifts into i and is skipped
        i += 1
    if ground_truth in matches:
        return 1.0 / len(matches)
    return 0.0


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _rouge_l_f(prediction: str, ground_truth: str) -> float:
    """rouge-l f-measure; uses the `rouge` package when importable."""
    try:
        from rouge import Rouge
        try:
            scores = Rouge().get_scores([prediction], [ground_truth], avg=True)
            return scores["rouge-l"]["f"]
        except Exception:
            return 0.0
    except ImportError:
        pass
    # LCS fallback (sentence-level, beta -> recall-weighted like rouge pkg)
    p = prediction.split()
    g = ground_truth.split()
    lcs = _lcs_len(p, g)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def rouge_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return _rouge_l_f(prediction, ground_truth)


def _jieba_cut(s: str) -> list[str]:
    try:
        import jieba
        return list(jieba.cut(s, cut_all=False))
    except ImportError:
        return list(s)


def rouge_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return _rouge_l_f(" ".join(_jieba_cut(prediction)),
                      " ".join(_jieba_cut(ground_truth)))


def f1_score(prediction, ground_truth, **kwargs) -> float:
    common = Counter(prediction) & Counter(ground_truth)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(prediction)
    recall = num_same / len(ground_truth)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return f1_score(normalize_answer(prediction).split(),
                    normalize_answer(ground_truth).split())


def qa_f1_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    pred = [normalize_zh_answer(t) for t in _jieba_cut(prediction)]
    gt = [normalize_zh_answer(t) for t in _jieba_cut(ground_truth)]
    pred = [t for t in pred if t]
    gt = [t for t in gt if t]
    if not pred or not gt:
        return 0.0
    return f1_score(pred, gt)


DATASET2METRIC = {
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "multifieldqa_zh": qa_f1_zh_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "dureader": rouge_zh_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "vcsum": rouge_zh_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "lsht": classification_score,
    "passage_count": count_score,
    "passage_retrieval_en": retrieval_score,
    "passage_retrieval_zh": retrieval_zh_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
}


def _passkey_score(prediction: str, ground_truth: str, **kwargs) -> float:
    from mustafar_tpu_torch.harness.tinylm import passkey_score
    return passkey_score(prediction, ground_truth, **kwargs)


# local synthetic long-context retrieval probe (harness/tinylm.py)
DATASET2METRIC["passkey"] = _passkey_score
