"""The CLIP byte-level BPE tokenizer: the native library's, and its plain
Python version.

Counterpart of ``stabletriton_tpu/io/tokenizer.py``. From a checkpoint's
``vocab.json`` and ``merges.txt`` (every SDXL, SD1.x and SD2.x distribution
ships them per text encoder), prompts become the fixed 77-token frames the
encoders take. :class:`PyCLIPTokenizer` is the plain version;
:class:`CLIPTokenizer` runs the native library's (``native.py``, built from
``native/src/tokenizer.cpp``) and the tests hold the two equal.

SDXL's framing: bos 49406, eos 49407; encoder 1 pads with eos, encoder 2
(OpenCLIP bigG) with 0. The ids come out as int32 arrays (B, 77), the form
``SDXLPipeline.txt2img(ids1, ids2, ...)`` takes; a prompt of several
77-token windows (:meth:`CLIPTokenizer.encode_windows`) is encoded window by
window by ``clip_apply_chunked``.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from stabletriton_tpu_torch import native


@functools.cache
def _byte_encoder() -> dict[int, str]:
    """GPT-2/CLIP bytes -> unicode: visible latin-1 bytes map to themselves,
    the rest to 256 + n in order."""
    direct = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
              + list(range(0xAE, 0x100)))
    mapping = {}
    next_cp = 256
    for b in range(256):
        if b in direct:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(next_cp)
            next_cp += 1
    return mapping


class PyCLIPTokenizer:
    """The plain version of the CLIP byte-level BPE."""

    def __init__(self, vocab_path: str | Path, merges_path: str | Path):
        self.vocab: dict[str, int] = json.loads(Path(vocab_path).read_text())
        ranks: dict[tuple[str, str], int] = {}
        for line in Path(merges_path).read_text().splitlines():
            if not line or line.startswith("#"):
                continue
            a, _, b = line.partition(" ")
            ranks[(a, b)] = len(ranks)
        self.ranks = ranks
        self.unk = self.vocab.get("<|endoftext|>", 0)

    def _bpe(self, symbols: list[str]) -> list[str]:
        while len(symbols) > 1:
            best, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def encode_word(self, word: str) -> list[int]:
        enc = _byte_encoder()
        symbols = [enc[b] for b in word.encode("utf-8")]
        if not symbols:
            return []
        symbols[-1] += "</w>"
        return [self.vocab.get(s, self.unk) for s in self._bpe(symbols)]

    @staticmethod
    def pretokenize(text: str) -> list[str]:
        """The ASCII approximation of CLIP's regex the native library uses:
        whitespace collapsed, lower case, then contractions, letter runs,
        single digits and runs of other characters."""
        t = " ".join(text.split()).lower()
        contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

        def is_letter(c):
            return c.isascii() and c.isalpha() or ord(c) >= 0x80

        def is_digit(c):
            return c.isascii() and c.isdigit()

        i, out = 0, []
        while i < len(t):
            c = t[i]
            if c == " ":
                i += 1
                continue
            if c == "'":
                matched = next((cs for cs in contractions if t.startswith(cs, i)), None)
                if matched:
                    out.append(matched)
                    i += len(matched)
                    continue
            j = i
            if is_letter(c):
                while j < len(t) and is_letter(t[j]):
                    j += 1
            elif is_digit(c):
                j = i + 1
            else:
                while j < len(t) and t[j] != " " and not is_letter(t[j]) and not is_digit(t[j]):
                    j += 1
            out.append(t[i:j])
            i = j
        return out

    def encode(self, text: str, *, max_len: int = 77, bos: int = 49406,
               eos: int = 49407, pad: int = 49407) -> np.ndarray:
        ids = [bos]
        for word in self.pretokenize(text):
            ids.extend(self.encode_word(word))
        ids = ids[: max_len - 1] + [eos]
        ids += [pad] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


class CLIPTokenizer:
    """The tokenizer on the native library's BPE. Building or loading the
    library, or reading the vocabulary there, raises on failure."""

    def __init__(self, vocab_path: str | Path, merges_path: str | Path):
        self._py = PyCLIPTokenizer(vocab_path, merges_path)
        self._lib = native.lib()
        self._handle = self._lib.st_tok_create(str(vocab_path).encode(),
                                               str(merges_path).encode())
        if not self._handle:
            raise ValueError(f"the native tokenizer could not read {vocab_path} / {merges_path}")

    def encode(self, text: str, *, max_len: int = 77, bos: int = 49406,
               eos: int = 49407, pad: int = 49407) -> np.ndarray:
        """One prompt -> (max_len,) int32 ids: bos, the BPE ids (truncated),
        eos, then ``pad``."""
        if max_len < 2:
            raise ValueError(f"max_len must be at least 2, got {max_len}")
        out = np.empty(max_len, np.int32)
        n = self._lib.st_tok_encode(self._handle, text.encode("utf-8"), out.ctypes.data,
                                    max_len, bos, eos, pad)
        if n < 0:
            raise RuntimeError("the native tokenizer failed")
        return out

    def encode_batch(self, texts: list[str], **kw) -> np.ndarray:
        return np.stack([self.encode(t, **kw) for t in texts])

    def encode_windows(self, text: str, *, windows: int | None = None, max_len: int = 77,
                       bos: int = 49406, eos: int = 49407, pad: int = 49407) -> np.ndarray:
        """A long prompt in (max_len - 2)-token windows, each framed with bos
        and eos (A1111's convention, which ``clip_apply_chunked`` encodes):
        (windows * max_len,) ids; ``windows=None`` takes as many as the
        prompt needs, at least one."""
        per = max_len - 2
        ids: list[int] = []
        for word in self._py.pretokenize(text):
            ids.extend(self._py.encode_word(word))
        k = windows or max(1, -(-len(ids) // per))
        rows = []
        for i in range(k):
            chunk = ids[i * per:(i + 1) * per]
            rows.append(np.asarray([bos] + chunk + [eos] + [pad] * (per - len(chunk)), np.int32))
        return np.concatenate(rows)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.st_tok_free(handle)
            self._handle = None


def sdxl_tokenize(tok1: CLIPTokenizer, tok2: CLIPTokenizer, prompts: list[str]):
    """(ids1, ids2), each (B, 77) int32, with SDXL's padding per encoder."""
    return tok1.encode_batch(prompts, pad=49407), tok2.encode_batch(prompts, pad=0)
