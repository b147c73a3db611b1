"""Tiny byte-level LM: accuracy evidence on trained weights, port of the JAX
package's ``harness/tinylm.py``.

The reference's claim is about accuracy: unstructured KV pruning at 50-70 %
sparsity keeps long-context task quality (pred_long_bench.py:49-86,
eval_long_bench.py:66-75).  The JAX package trained a small Llama on local
text plus a synthetic passkey-retrieval task (``ckpt/tiny-acc*``); this
module scores such a checkpoint, dense against pruned caches, through the
port's engine and the LongBench harness (predict -> jsonl -> scorer).

Components:
  * ByteTokenizer        — the UTF-8 byte tokenizer (the HF API subset the
                           harness calls)
  * load_corpus          — local text (installed Python sources)
  * make_passkey_row     — a needle in a haystack, as a LongBench row
  * make_training_batch  — text windows and passkey documents, weighted
  * train, save_ckpt     — AdamW training and the checkpoint's files
  * score_nll            — teacher-forced NLL through prefill and decode
  * run_accuracy         — the dense vs pruned grid -> result dict

Checkpoints load through ``weights.load_ckpt``.  Training (``train``:
``make_training_batch``, ``llama.lm_forward``'s weighted loss, AdamW on
optax's warmup-cosine schedule, ``save_ckpt``) writes the checkpoints the
JAX package's ``train`` writes.  The functions that touch a device take
``device`` (None: ``cuda``, raising without a card), as ``Generator``
does.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from mustafar_tpu_torch.config import (CacheMode, EngineConfig, ModelConfig,
                                       PruneConfig, PruneMethod)
from mustafar_tpu_torch.device import resolve_device

VOCAB = 258          # 256 bytes + BOS(256) + EOS(257)
BOS_ID, EOS_ID = 256, 257

# Llama-architecture; head_dim=128 so the compressed formats apply.
TINY_ACC = ModelConfig(
    name="tiny-acc", vocab_size=VOCAB, hidden_size=256, intermediate_size=768,
    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=128,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096,
)

PASSKEY_QUESTION = "\n\nWhat is the pass key? The pass key is"
NEEDLE = " The pass key is {key}. Remember it. {key} is the pass key. "


class ByteTokenizer:
    """UTF-8 byte tokenizer with the subset of the HF API the harness uses."""

    eos_token_id = EOS_ID
    bos_token_id = BOS_ID

    def encode(self, text: str, add_special_tokens: bool = False):
        ids = list(text.encode("utf-8", errors="replace"))
        return [BOS_ID] + ids if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens: bool = True):
        arr = [int(i) for i in np.asarray(ids).reshape(-1) if int(i) < 256]
        return bytes(arr).decode("utf-8", errors="replace")

    def __call__(self, text: str, truncation: bool = False,
                 return_tensors: Optional[str] = None):
        ids = self.encode(text)

        class _Enc:
            pass

        enc = _Enc()
        if return_tensors == "np":
            enc.input_ids = np.asarray([ids], np.int32)
        else:
            enc.input_ids = ids
        return enc


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

_CORPUS_ROOTS = [
    "/usr/lib/python3.11", "/usr/lib/python3.10", "/usr/lib/python3.12",
    "/opt/venv/lib",
]


def load_corpus(max_bytes: int = 6_000_000, seed: int = 0) -> str:
    """Concatenate local text (python sources) into one corpus; asserts that
    the roots (``_CORPUS_ROOTS``) gave more than 100,000 characters."""
    files = []
    for root in _CORPUS_ROOTS:
        if os.path.isdir(root):
            files.extend(sorted(glob.glob(os.path.join(root, "**/*.py"),
                                          recursive=True))[:4000])
        if len(files) > 6000:
            break
    rng = np.random.RandomState(seed)
    rng.shuffle(files)
    parts, total = [], 0
    for p in files:
        try:
            with open(p, encoding="utf-8", errors="ignore") as f:
                t = f.read()
        except OSError:
            continue
        parts.append(t)
        total += len(t)
        if total >= max_bytes:
            break
    text = "\n\n".join(parts)
    assert len(text) > 100_000, "corpus too small"
    return text


def _filler(corpus: str, rng: np.random.RandomState, n: int) -> str:
    start = rng.randint(0, max(1, len(corpus) - n - 1))
    return corpus[start:start + n]


def make_passkey_row(corpus: str, rng: np.random.RandomState,
                     ctx_bytes: int, depth: Optional[float] = None) -> dict:
    """LongBench-schema row: the needle at a random (or fixed) relative depth."""
    key = "".join(str(rng.randint(0, 10)) for _ in range(5))
    needle = NEEDLE.format(key=key)
    body = ctx_bytes - len(needle)
    d = rng.uniform(0.1, 0.85) if depth is None else depth
    pre = _filler(corpus, rng, int(body * d))
    post = _filler(corpus, rng, body - int(body * d))
    context = pre + needle + post
    return {"context": context, "input": "", "answers": [key],
            "all_classes": None, "length": len(context)}


def make_training_batch(corpus: str, rng: np.random.RandomState,
                        batch: int, seq: int, passkey_frac: float = 0.5):
    """Returns (tokens [B, seq] int32, weights [B, seq] f32), the JAX
    package's draws from ``rng`` bit for bit.

    Mixture of plain text windows and passkey documents; the passkey answer
    span gets upweighted loss so the copy behaviour trains quickly."""
    toks = np.zeros((batch, seq), np.int32)
    wts = np.ones((batch, seq), np.float32)
    for b in range(batch):
        if rng.rand() < passkey_frac:
            ctx_bytes = rng.randint(seq // 4, seq - 64)
            row = make_passkey_row(corpus, rng, ctx_bytes)
            doc = row["context"] + PASSKEY_QUESTION + " " + row["answers"][0]
            ids = [BOS_ID] + list(doc.encode("utf-8", errors="replace"))[:seq - 2] + [EOS_ID]
            # answer span = last 6 bytes (" " + 5 digits) + EOS
            ids = ids[:seq]
            toks[b, :len(ids)] = ids
            span = min(7, len(ids) - 1)
            wts[b, len(ids) - span:len(ids)] = 8.0
            if len(ids) < seq:  # tail: more text, ordinary LM loss
                tail = _filler(corpus, rng, seq - len(ids))
                tids = list(tail.encode("utf-8", errors="replace"))[: seq - len(ids)]
                toks[b, len(ids):len(ids) + len(tids)] = tids
        else:
            window = _filler(corpus, rng, seq + 8)
            ids = ([BOS_ID] + list(window.encode("utf-8", errors="replace")))[:seq]
            toks[b, :len(ids)] = ids
    return toks, wts


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_config(seq: int, hidden: int = None, layers: int = None, window: int = None,
                 rope_theta: float = None) -> ModelConfig:
    """The JAX package's ``train`` config rules on ``TINY_ACC``: hidden (with
    an intermediate of 3 x hidden) and layers, positions at least 2 x seq,
    ``rope_theta``, a sliding ``window``."""
    cfg = TINY_ACC
    if hidden or layers:
        cfg = dataclasses.replace(
            cfg, hidden_size=hidden or cfg.hidden_size,
            intermediate_size=3 * (hidden or cfg.hidden_size),
            num_layers=layers or cfg.num_layers,
            name=f"tiny-acc-h{hidden or cfg.hidden_size}L{layers or cfg.num_layers}")
    if seq * 2 > cfg.max_position_embeddings:
        cfg = dataclasses.replace(cfg, max_position_embeddings=2 * seq)
    if rope_theta:
        cfg = dataclasses.replace(cfg, rope_theta=float(rope_theta))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window, name=f"{cfg.name}-sw{window}")
    return cfg


def lr_schedule(lr: float, steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1), 0.05 lr)`` with the JAX package's warmup of min(100,
    max(1, steps // 10)) steps, as a function of the update's index (0 for
    the first, whose rate is 0)."""
    warmup = min(100, max(1, steps // 10))
    decay = max(steps, warmup + 1) - warmup
    end = 0.05 * lr

    def rate(k: int) -> float:
        if k < warmup:
            return lr * k / warmup
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(k - warmup, decay) / decay))
        return lr * ((1.0 - end / lr) * cosine + end / lr)

    return rate


def make_optimizer(leaves: list, lr: float, steps: int):
    """(``torch.optim.AdamW``, its ``LambdaLR``): optax's ``adamw(schedule,
    b1=0.9, b2=0.95, weight_decay=0.01)`` (eps 1e-8; every leaf decayed, as
    optax decays without a mask) on ``lr_schedule``.  Call the scheduler's
    ``step`` after each optimizer step."""
    opt = torch.optim.AdamW(leaves, lr=1.0, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(lr, steps))


def training_loss(cfg: ModelConfig, params: dict, toks: torch.Tensor, wts: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """Weighted next-token cross-entropy of ``llama.lm_forward``'s f32
    logits: sum(ce * w[:, 1:]) / sum(w[:, 1:])."""
    from mustafar_tpu_torch.models import llama

    logits = llama.lm_forward(cfg, params, toks, remat=remat)
    V = logits.shape[-1]
    ce = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, V),
                                           toks[:, 1:].reshape(-1), reduction="none")
    w = wts[:, 1:].reshape(-1)
    return (ce * w).sum() / w.sum()


def train(out_dir: str, steps: int = 3000, batch: int = 8, seq: int = 2048,
          lr: float = 1e-3, seed: int = 0, inner: int = 25,
          hidden: int = None, layers: int = None, window: int = None,
          rope_theta: float = None, log=print, device=None, remat: bool = True) -> dict:
    """Train the tiny byte-level model (``train_config``) on
    ``make_training_batch`` draws from the corpus, ``steps`` AdamW steps
    (``make_optimizer``) of the weighted loss (``training_loss``), on
    ``device`` (default ``cuda``), and write the checkpoint (``save_ckpt``).
    Logs the mean and last loss every ``inner`` steps, as the JAX package's
    ``train`` does after each scanned chunk; the weights start from the
    port's ``init_params`` (seed ``seed``; the JAX package's random bits
    differ).  Returns the final loss and the steps, as the JAX package's
    does, and every step's loss and wall seconds (the batch's draw left
    out)."""
    from mustafar_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = train_config(seq, hidden, layers, window, rope_theta)
    corpus = load_corpus(seed=seed)
    rng = np.random.RandomState(seed)
    params = llama.init_params(cfg, device=dev, dtype=torch.float32, seed=seed)
    leaves = _leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt, sched = make_optimizer(leaves, lr, steps)
    losses, step_s = [], []
    for done in range(1, steps + 1):
        toks, wts = make_training_batch(corpus, rng, batch, seq)
        t = time.perf_counter()
        loss = training_loss(cfg, params, torch.as_tensor(toks, device=dev).long(),
                             torch.as_tensor(wts, device=dev), remat)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(float(loss.detach()))      # waits for the step
        step_s.append(time.perf_counter() - t)
        if done % inner == 0 or done == steps:
            chunk = losses[-((done - 1) % inner + 1):]
            log(f"step {done}/{steps}  loss {np.mean(chunk):.4f} (last {losses[-1]:.4f})")
    save_ckpt(out_dir, cfg, params)
    return {"final_loss": losses[-1] if losses else None, "steps": steps,
            "losses": losses, "step_s": step_s}


def _leaves(params: dict) -> list:
    return [v for k in sorted(params) for v in (
        _leaves(params[k]) if isinstance(params[k], dict) else [params[k]])]


def save_ckpt(out_dir: str, cfg: ModelConfig, params: dict) -> None:
    """``params.npz`` (one f32 array a leaf, keys ``embed``, ``layers/wq``,
    ..., in JAX's sorted order) and ``config.json`` (the config's fields,
    indent 2), the files the JAX package's ``save_ckpt`` writes: both
    packages' ``load_ckpt`` read them."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for k in sorted(params):
        if isinstance(params[k], dict):
            flat.update({f"{k}/{kk}": params[k][kk] for kk in sorted(params[k])})
        else:
            flat[k] = params[k]
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in flat.items()})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _engine(cfg: ModelConfig, mode: str, sparsity: float,
            max_seq_len: int) -> EngineConfig:
    """Grid-mode grammar (each mode string names one engine variant):

        dense
        (masked|compressed)[-<codec>][:<method>][+chunked][+r<N>][+c<N>]

    ``codec``: bitmap (default) | bitmap-q8 | q8 | q8q4 | q4q4 (compressed
    only).  ``method``: a PruneMethod value (default kt_mag_vt_mag).
    ``+chunked``: chunked (segment-streamed) prefill (compressed only);
    ``+rN`` / ``+cN``: residual window / compaction chunk size overrides.
    Examples: ``masked:kt_mag_vt_opa``, ``compressed-q8q4:kt_opa_vt_mag+chunked``,
    ``compressed-q8q4+r64+c128``.
    """
    if mode == "dense":
        return EngineConfig(model=cfg, cache_mode=CacheMode.DENSE,
                            max_seq_len=max_seq_len)
    parts = mode.split("+")
    base, flags = parts[0], parts[1:]
    method = "kt_mag_vt_mag"
    if ":" in base:
        base, method = base.split(":", 1)
    codec = "bitmap"
    if base.startswith("compressed-"):
        base, codec = base.split("-", 1)
    assert base in ("masked", "compressed"), mode
    chunked, residual, chunk = False, 32, 256
    for f in flags:
        if f == "chunked":
            chunked = True
        elif f[:1] == "r":
            residual = int(f[1:])
        elif f[:1] == "c":
            chunk = int(f[1:])
        else:
            raise ValueError(f"unknown grid-mode flag {f!r} in {mode!r}")
    cache = CacheMode.MASKED if base == "masked" else CacheMode.COMPRESSED
    return EngineConfig(
        model=cfg, cache_mode=cache,
        prune=PruneConfig(method=PruneMethod(method), k_sparsity=sparsity,
                          v_sparsity=sparsity, residual_length=residual),
        max_seq_len=max_seq_len, codec=codec, chunk_size=chunk,
        chunked_prefill=chunked)


@torch.inference_mode()
def score_nll(engine: EngineConfig, params, tokens: np.ndarray,
              prefill_len: int = 256, dtype=torch.float32, device=None):
    """Teacher-forced scoring through prefill and the decode path.

    tokens [B, T].  Prefills the first ``prefill_len`` (P) tokens (chunked
    with ``engine.chunked_prefill``), then decodes the rest one step at a
    time with the engine's cache, pruning and compaction included: step i
    (1 <= i <= T - P) feeds token P + i - 1 at its position, after a
    compaction wherever the window of the P + i - 1 tokens so far is full,
    the steps at which the JAX package's loop compacts.  Returns (the mean
    NLL over the buffer's targets, tokens P .. T - 1; the f32 logits buffer
    [B, T - P, V] on the device).

    The buffer is the JAX package's, slot for slot: its loop writes step
    i's logits at slot i, clamped to the last slot, so slot 0 (token P)
    keeps zero logits and the last slot holds the step that reads token
    T - 1 (a prediction past the end).  The port keeps both, so its numbers
    compare with the JAX package's and its recorded grids.
    """
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = engine.model
    impl = make_cache(engine, device=dev)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(dev)
    B, T = toks.shape
    P = prefill_len
    n_dec = T - P
    cache = impl.init(B, dtype)
    if engine.chunked_prefill:
        _, cache = llama.prefill_chunked(cfg, params, toks[:, :P], cache, impl, P)
    else:
        _, cache = llama.prefill(cfg, params, toks[:, :P], cache, impl, P, last_only=True)
    buf = torch.zeros((B, n_dec, cfg.vocab_size), dtype=torch.float32, device=dev)
    has_compact = hasattr(impl, "compact")
    for i in range(1, n_dec + 1):
        pos = P + i - 1                          # the position of the fed token
        if has_compact and impl.window_full(cache, pos):
            impl.compact(cache)
        lg, cache = llama.decode_step(cfg, params, toks[:, pos:pos + 1], cache, impl, pos)
        buf[:, min(i, n_dec - 1)] = lg[:, 0].to(torch.float32)
    lp = torch.log_softmax(buf, dim=-1)
    nll = -torch.gather(lp, -1, toks[:, P:, None])[..., 0]
    return float(nll.mean()), buf


def kl_vs(logits_ref, logits_other) -> float:
    """mean KL(ref || other) over all scored positions."""
    p = torch.log_softmax(torch.as_tensor(logits_ref).to(torch.float32), -1)
    q = torch.log_softmax(torch.as_tensor(logits_other).to(torch.float32), -1)
    kl = torch.sum(torch.exp(p) * (p - q), dim=-1)
    return float(kl.mean())


# ---------------------------------------------------------------------------
# Accuracy grid
# ---------------------------------------------------------------------------

def _quantizer(tag: str):
    from mustafar_tpu_torch.models import quant
    return {"+w8": quant.quantize_params,
            "+w4": quant.quantize_params_w4,
            "+w8a8": lambda p: quant.enable_act_quant(quant.quantize_params(p))}[tag]


def run_accuracy(ckpt_dir: str, out_dir: str, n_rows: int = 40,
                 ctx_bytes: int = 1600, sparsities=(0.5, 0.7),
                 modes=("masked", "compressed"), seed: int = 1234,
                 nll_tokens: int = 1024, depths=None, log=print, device=None) -> dict:
    """Dense vs pruned accuracy grid on a trained checkpoint, on ``device``.

    Passkey retrieval runs through the harness (predict_dataset -> jsonl ->
    scorer with the 'passkey' digit-EM metric); NLL / KL through
    ``score_nll``.  A mode ending in ``+w8``, ``+w4`` or ``+w8a8`` runs its
    variant with int8, int4 or W8A8 weights (``models/quant.py``).  Writes
    ``<out_dir>/result.json``, and each variant's ``passkey.jsonl`` under
    ``<out_dir>/<variant>/``.

    ``depths``: optional tuple of needle depths (fractions into the
    context).  When given, rows are placed at those fixed depths round-robin
    and each variant additionally reports per-depth accuracy.
    """
    from mustafar_tpu_torch.harness.longbench import PredictConfig, predict_dataset, scorer
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.weights import load_ckpt

    dev = resolve_device(device)
    cfg, params = load_ckpt(ckpt_dir, device=dev)
    corpus = load_corpus(seed=seed + 1)
    rng = np.random.RandomState(seed)
    tok = ByteTokenizer()

    if depths:
        row_depths = [depths[i % len(depths)] for i in range(n_rows)]
        rows = [make_passkey_row(corpus, rng, ctx_bytes, depth=d)
                for d in row_depths]
    else:
        row_depths = None
        rows = [make_passkey_row(corpus, rng, ctx_bytes) for _ in range(n_rows)]
    # held-out text for NLL (disjoint seed from training)
    nll_toks = np.stack([
        np.asarray([BOS_ID] + list(_filler(corpus, rng, nll_tokens + 8)
                                   .encode("utf-8", "replace"))[:nll_tokens - 1],
                   np.int32)
        for _ in range(4)])

    max_seq = ((ctx_bytes + len(PASSKEY_QUESTION) + 256) // 256 + 1) * 256 + 256
    grid = [("dense", 0.0)] + [(m, s) for m in modes for s in sparsities]
    results = {}
    ref_logits = None
    qcache = {}
    for mode, s in grid:
        run_params, wtag = params, ""
        for tag in ("+w8a8", "+w8", "+w4"):
            if mode.endswith(tag):
                if tag not in qcache:
                    qcache[tag] = _quantizer(tag)(params)
                run_params, mode, wtag = qcache[tag], mode[: -len(tag)], tag
                break
        name = ("dense" if mode == "dense" else f"{mode}@{s}") + wtag
        if name in results:   # e.g. dense+w8 is sparsity-independent
            continue
        eng = _engine(cfg, mode, s, max_seq)
        gen = Generator(eng, run_params, dtype=torch.float32, device=dev)
        pc = PredictConfig(model_name=cfg.name, max_length=max_seq - 64,
                           out_dir=os.path.join(out_dir, name))
        preds = predict_dataset(gen, tok, "passkey", rows, pc,
                                eos_id=EOS_ID, progress=False)
        acc = scorer("passkey", [p["pred"] for p in preds],
                     [p["answers"] for p in preds], None)
        nll, logits = score_nll(eng, run_params, nll_toks, device=dev)
        ent = {"passkey_acc": acc, "nll": round(nll, 4),
               "ppl_bits": round(nll / np.log(2), 4)}
        if row_depths is not None:
            per = {}
            for d, p in zip(row_depths, preds):
                per.setdefault(d, []).append(
                    passkey_score(p["pred"], p["answers"][0]))
            ent["acc_by_depth"] = {f"{d:.2f}": round(100 * np.mean(v), 1)
                                   for d, v in sorted(per.items())}
        if mode == "dense":
            ref_logits = logits
        else:
            ent["kl_vs_dense"] = round(kl_vs(ref_logits, logits), 5)
        results[name] = ent
        log(f"{name}: {ent}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def passkey_score(prediction: str, ground_truth: str, **kwargs) -> float:
    """Digit exact-match: first digit run in the prediction vs the key."""
    m = re.search(r"\d+", prediction)
    return float(bool(m) and m.group(0) == ground_truth)
