"""A local HF tokenizer directory without ``transformers``: the counterpart
of ``AutoTokenizer.from_pretrained(path)`` for the harness.

``tokenizer.json`` is read with the ``tokenizers`` library and
``tokenizer_config.json`` gives the special tokens, the chat template and
``clean_up_tokenization_spaces``.  Only what the harness calls is here:

* ``tok(text, truncation=False, return_tensors="np").input_ids`` [1, n]:
  special tokens added, as ``AutoTokenizer.__call__`` adds them by default
  (the tokenizer's post-processor, e.g. Llama-3's BOS);
* ``encode(text, add_special_tokens=False)``, a list of ids;
* ``decode(ids, skip_special_tokens=True)``;
* ``eos_token_id`` (and ``bos_token_id``);
* ``apply_chat_template(messages, tokenize=False, add_generation_prompt=True)``:
  the config's ``chat_template`` rendered with ``jinja2`` in a sandbox with
  the settings and helpers ``transformers`` gives it (trim_blocks,
  lstrip_blocks, loop controls, ``raise_exception``, a ``tojson`` that does
  not escape HTML, ``strftime_now``, the special tokens by name; not its
  ``{% generation %}`` tag, which only marks assistant tokens).

``tokenizers`` and ``jinja2`` are imported inside the calls that need them.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_SPECIAL_NAMES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                  "cls_token", "mask_token")


def _token_text(value) -> Optional[str]:
    """A special token as tokenizer_config.json holds it: a string or an
    AddedToken's dict (``{"content": ...}``)."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def clean_up_tokenization(text: str) -> str:
    """``transformers``' clean-up of spaces before punctuation and
    contractions (used where the config sets clean_up_tokenization_spaces)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids


class LocalTokenizer:
    """The tokenizer of a local HF directory (module note)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self.path = path
        self._tok = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        self.special_tokens_map = {name: _token_text(cfg[name]) for name in _SPECIAL_NAMES
                                   if _token_text(cfg.get(name)) is not None}
        self.clean_up_tokenization_spaces = bool(cfg.get("clean_up_tokenization_spaces",
                                                         False))
        self.chat_template = cfg.get("chat_template")

    @classmethod
    def from_pretrained(cls, path: str) -> "LocalTokenizer":
        return cls(path)

    def _special_id(self, name: str) -> Optional[int]:
        text = self.special_tokens_map.get(name)
        return None if text is None else self._tok.token_to_id(text)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._special_id("eos_token")

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._special_id("bos_token")

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def __call__(self, text: str, truncation: bool = False,
                 return_tensors: Optional[str] = None):
        ids = self.encode(text)
        if return_tensors == "np":
            return _Encoding(np.asarray([ids], np.int64))
        if return_tensors is not None:
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np' is served")
        return _Encoding(ids)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        text = self._tok.decode(ids, skip_special_tokens=skip_special_tokens)
        return clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    def apply_chat_template(self, messages: list, tokenize: bool = False,
                            add_generation_prompt: bool = False) -> str:
        """The rendered text (``tokenize=True`` is not served)."""
        if tokenize:
            raise ValueError("apply_chat_template: only tokenize=False is served")
        if self.chat_template is None:
            raise ValueError(f"{self.path}: the tokenizer has no chat template")
        return render_chat_template(self.chat_template, messages,
                                    add_generation_prompt=add_generation_prompt,
                                    **self.special_tokens_map)


def render_chat_template(template: str, messages: list, add_generation_prompt: bool = False,
                         **kwargs) -> str:
    """Render a chat template as ``transformers`` does (module note)."""
    from datetime import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(template).render(messages=messages, tools=None, documents=None,
                                            add_generation_prompt=add_generation_prompt,
                                            **kwargs)
