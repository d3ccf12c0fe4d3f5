"""Byte-level (ByT5) tokenizer, dependency-free.

The reference loads HuggingFace ``google/byt5-small`` and only ever calls
``tokenizer(text)["input_ids"]`` (streaming_server.py:306, src/data.py:140).
ByT5 tokenization is fixed arithmetic: UTF-8 byte ``b`` maps to id ``b + 3``
(ids 0/1/2 are <pad>/</s>/<unk>), every encode appends the </s> id 1, and
ids 259..383 are unused sentinel tokens.  The reference then grows the vocab
with two specials, ``[PAD]``=384 and ``EOS``=385
(inference/model_handler.py:91-102).  We implement exactly that, with no HF
dependency on the serving hot path.
"""
from __future__ import annotations

from typing import List, Sequence

PAD_ID = 0
EOS_ID = 1          # </s> appended by every HF tokenizer call
UNK_ID = 2
BYTE_OFFSET = 3
BASE_VOCAB = 384    # 3 specials + 256 bytes + 125 extra-id sentinels
SPEECH_PAD_ID = 384  # "[PAD]" special added by the reference
SPEECH_EOS_ID = 385  # "EOS" special added by the reference
VOCAB_SIZE = 386


class ByT5Tokenizer:
    """Minimal ByT5-compatible byte tokenizer.

    ``encode`` matches ``AutoTokenizer.from_pretrained('google/byt5-small')
    (text)['input_ids']``: UTF-8 bytes + 3, with a trailing </s> (id 1).
    """

    vocab_size = VOCAB_SIZE
    pad_token_id = SPEECH_PAD_ID
    eos_token_id = SPEECH_EOS_ID
    model_max_length = 1 << 30  # byt5-small ships no real cap

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = [b + BYTE_OFFSET for b in text.encode("utf-8")]
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def __call__(self, text) -> dict:
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return {"input_ids": [self.encode(t) for t in text]}

    def encode_words(self, text: str) -> List[int]:
        """Per-word tokenization flattened, + speech-text EOS 385.

        Mirrors the training text pipeline (src/data.py:139-141): the answer
        text is split on spaces, each word is tokenized (each getting its
        own trailing </s>), flattened, and 385 is appended.
        """
        out: List[int] = []
        for word in text.split(" "):
            out.extend(self.encode(word))
        out.append(SPEECH_EOS_ID)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - BYTE_OFFSET for i in ids if BYTE_OFFSET <= i < BYTE_OFFSET + 256
        )
        return data.decode("utf-8", errors="ignore")
