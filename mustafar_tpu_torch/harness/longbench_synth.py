"""Synthetic LongBench rows for every task (THUDM schema, nothing
downloaded): the port's copy of the JAX package's
``harness/longbench_synth.py``.

Each task gets schema-correct rows built from the local text corpus:
answerable QA with a planted fact, summarizable paragraphs, classification
with real class lists, paragraph retrieval, duplicate counting, code
completion, and the zh variants with Chinese text.  On a small or random
model the scores are near chance; what the rows exercise is coverage (every
template, every metric, the samsum newline stop, zh tokenization) through
the predict -> jsonl -> scorer pipeline.
"""

from __future__ import annotations

import numpy as np

from mustafar_tpu_torch.harness import configs
from mustafar_tpu_torch.harness.tinylm import make_passkey_row, _filler

_CAPITALS = ["Sylvania", "Osterlich", "Brandopolis", "Vestara"]
_CAPITALS_ZH = ["西尔瓦尼亚", "奥斯特里奇", "布兰多城", "维斯塔拉"]

_ZH_FILLER = (
    "会议开始后，大家首先讨论了上个季度的工作进展。负责生产的同事介绍了车间的改造情况，"
    "包括设备更新、人员培训和安全检查等方面的内容。随后，销售部门汇报了市场拓展的最新动态，"
    "强调了华东地区客户数量的稳步增长。财务负责人分析了成本结构的变化，并提出了下一阶段的预算安排。"
    "技术团队展示了新产品的研发路线图，讨论了原型测试中发现的问题及改进方案。"
    "人事部门通报了招聘进度和员工满意度调查的结果。最后，总经理对各部门的工作提出了具体要求，"
    "希望大家加强协作，按时完成年度目标。")

_TREC_CLASSES = [
    "Abbreviation", "Entity", "Description and abstract concept",
    "Human being", "Location", "Numeric value"]
_LSHT_CLASSES = ["农业", "体育", "军事", "经济", "科技", "教育"]

_CODE_SNIPPET = '''\
def fibonacci(n):
    """Return the n-th Fibonacci number."""
    if n < 2:
        return n
    a, b = 0, 1
    for _ in range(n - 1):
        a, b = b, a + b
    return b


def main():
    values = [fibonacci(i) for i in range(10)]
'''


def _zh_text(rng: np.random.RandomState, n: int) -> str:
    s = _ZH_FILLER
    while len(s) < n:
        s += _ZH_FILLER
    start = rng.randint(0, max(1, len(s) - n - 1))
    return s[start:start + n]


def _qa_row(corpus, rng, ctx_bytes, zh=False):
    """Context with one planted fact; question asks for it."""
    if zh:
        i = rng.randint(len(_CAPITALS_ZH))
        ans = _CAPITALS_ZH[i]
        fact = f"据记载，弗里多尼亚的首都是{ans}。"
        body = _zh_text(rng, ctx_bytes - len(fact))
        q = "弗里多尼亚的首都是哪里？"
    else:
        i = rng.randint(len(_CAPITALS))
        ans = _CAPITALS[i]
        fact = f" The capital of Freedonia is {ans}. "
        body = _filler(corpus, rng, ctx_bytes - len(fact))
        q = "What is the capital of Freedonia?"
    cut = rng.randint(len(body) // 4, 3 * len(body) // 4)
    context = body[:cut] + fact + body[cut:]
    return {"context": context, "input": q, "answers": [ans],
            "all_classes": None, "length": len(context)}


def _summ_row(corpus, rng, ctx_bytes, zh=False, query=False):
    """Paragraphs whose first sentence doubles as the reference summary."""
    if zh:
        context = _zh_text(rng, ctx_bytes)
        summary = "会议讨论了生产、销售、财务、技术与人事等方面的工作进展。"
        inp = ""
    else:
        paras = [_filler(corpus, rng, ctx_bytes // 3) for _ in range(3)]
        context = "\n\n".join(paras)
        summary = "The report reviews recent progress and outlines next steps."
        inp = ("Summarize the main points of the discussion."
               if query else "")
    return {"context": context, "input": inp, "answers": [summary],
            "all_classes": None, "length": len(context)}


def _samsum_row(corpus, rng, ctx_bytes):
    convo = ("Amy: Are we still on for lunch tomorrow?\n"
             "Bob: Yes, noon at the corner cafe.\n"
             "Amy: Perfect, I will book a table.\n"
             "Bob: Great, see you there!")
    shots = (f"Dialogue: {convo}\nSummary: Amy and Bob confirm lunch at the "
             "corner cafe at noon tomorrow.\n\n")
    target = ("Cara: Did you finish the report?\n"
              "Dan: Almost, sending it tonight.\n"
              "Cara: Thanks, the deadline is 9am.")
    return {"context": shots,
            "input": f"Dialogue: {target}\nSummary:",
            "answers": ["Dan will send Cara the report tonight before the "
                        "9am deadline."],
            "all_classes": None, "length": len(shots)}


def _class_row(corpus, rng, zh=False):
    if zh:
        classes = _LSHT_CLASSES
        label = classes[rng.randint(len(classes))]
        shots = "\n".join(f"新闻：这是一条关于{c}领域的报道。类别：{c}"
                          for c in classes[:4])
        inp = f"新闻：今天发布了一条与{label}密切相关的消息。类别："
    else:
        classes = _TREC_CLASSES
        label = classes[rng.randint(len(classes))]
        shots = "\n".join(
            f"Question: example question about {c.lower()}. Type: {c}"
            for c in classes[:4])
        inp = f"Question: tell me something that is a {label.lower()}. Type:"
    return {"context": shots, "input": inp, "answers": [label],
            "all_classes": classes, "length": len(shots)}


def _count_row(corpus, rng, ctx_bytes, n_para=8):
    uniq = rng.randint(2, n_para)
    paras = [_filler(corpus, rng, ctx_bytes // n_para) for _ in range(uniq)]
    idx = list(rng.randint(0, uniq, size=n_para - uniq)) + list(range(uniq))
    rng.shuffle(idx)
    context = "\n\n".join(f"Paragraph {i + 1}: {paras[j]}"
                          for i, j in enumerate(idx))
    return {"context": context, "input": "", "answers": [str(uniq)],
            "all_classes": None, "length": len(context)}


def _retrieval_row(corpus, rng, ctx_bytes, zh=False, n_para=6):
    k = rng.randint(n_para) + 1
    if zh:
        paras = [_zh_text(rng, ctx_bytes // n_para) for _ in range(n_para)]
        context = "\n\n".join(f"段落{i + 1}：{p}" for i, p in enumerate(paras))
        abstract = paras[k - 1][:60]
        ans = f"段落{k}"
    else:
        paras = [_filler(corpus, rng, ctx_bytes // n_para)
                 for _ in range(n_para)]
        context = "\n\n".join(f"Paragraph {i + 1}: {p}"
                              for i, p in enumerate(paras))
        abstract = paras[k - 1][:80]
        ans = f"Paragraph {k}"
    return {"context": context, "input": abstract, "answers": [ans],
            "all_classes": None, "length": len(context)}


def _code_row(corpus, rng, with_input=False):
    lines = _CODE_SNIPPET.rstrip("\n").split("\n")
    cut = len(lines) - 1
    context = "\n".join(lines[:cut]) + "\n"
    answer = lines[cut].strip()
    row = {"context": context, "input": "", "answers": [answer],
           "all_classes": None, "length": len(context)}
    if with_input:          # repobench-p: {context}{input} are concatenated
        row["context"], row["input"] = context[:len(context) // 2], \
            context[len(context) // 2:]
    return row


def make_task_rows(corpus: str, rng: np.random.RandomState, task: str,
                   n_rows: int, ctx_bytes: int = 1000) -> list[dict]:
    """n schema-correct rows for any of the 22 supported tasks."""
    builders = {
        "narrativeqa": lambda: _qa_row(corpus, rng, ctx_bytes),
        "qasper": lambda: _qa_row(corpus, rng, ctx_bytes),
        "multifieldqa_en": lambda: _qa_row(corpus, rng, ctx_bytes),
        "multifieldqa_zh": lambda: _qa_row(corpus, rng, ctx_bytes, zh=True),
        "hotpotqa": lambda: _qa_row(corpus, rng, ctx_bytes),
        "2wikimqa": lambda: _qa_row(corpus, rng, ctx_bytes),
        "musique": lambda: _qa_row(corpus, rng, ctx_bytes),
        "triviaqa": lambda: _qa_row(corpus, rng, ctx_bytes),
        "dureader": lambda: _qa_row(corpus, rng, ctx_bytes, zh=True),
        "gov_report": lambda: _summ_row(corpus, rng, ctx_bytes),
        "multi_news": lambda: _summ_row(corpus, rng, ctx_bytes),
        "qmsum": lambda: _summ_row(corpus, rng, ctx_bytes, query=True),
        "vcsum": lambda: _summ_row(corpus, rng, ctx_bytes, zh=True),
        "samsum": lambda: _samsum_row(corpus, rng, ctx_bytes),
        "trec": lambda: _class_row(corpus, rng),
        "lsht": lambda: _class_row(corpus, rng, zh=True),
        "passage_count": lambda: _count_row(corpus, rng, ctx_bytes),
        "passage_retrieval_en": lambda: _retrieval_row(corpus, rng, ctx_bytes),
        "passage_retrieval_zh": lambda: _retrieval_row(corpus, rng, ctx_bytes,
                                                       zh=True),
        "lcc": lambda: _code_row(corpus, rng),
        "repobench-p": lambda: _code_row(corpus, rng, with_input=True),
        "passkey": lambda: make_passkey_row(corpus, rng, ctx_bytes),
    }
    assert task in builders, task
    assert task in configs.DATASET2PROMPT, task
    return [builders[task]() for _ in range(n_rows)]
