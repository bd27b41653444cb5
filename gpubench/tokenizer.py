"""The traffic's tokenizer: deterministic ids without vocabulary files.

BOS, one id per character, EOS, then padding; CLIP pools at the first EOS.
Both the system under test (through its serving engine) and the reference
get their ids from it.
"""

from __future__ import annotations

import numpy as np


class StubTokenizer:
    def __init__(self, bos: int, eos: int):
        self.bos, self.eos = bos, eos

    def encode_batch(self, texts, *, max_len=77, pad=None, **kw):
        pad = self.eos if pad is None else pad
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + [(ord(c) % 400) + 300 for c in t[: max_len - 2]] + [self.eos]
            out[i, : len(ids)] = ids
        return out
