"""CoNLL-2005 SRL reader (reference: python/paddle/dataset/conll05.py —
yields 9 sequences: word_ids, 5 predicate-context ids, pred_ids, mark,
label_ids, all sentence-length aligned). Synthetic corpus: each sentence
gets one predicate and BIO role labels correlated with distance to the
predicate, so the reference's SRL model (tests/book label_semantic_roles)
has learnable structure.
Port of ``paddle_tpu/dataset/conll05.py``: the same seeded samples.
"""

import numpy as np

_WORDS = 1000
_VERBS = 50
_LABELS = ["O", "B-V", "I-V", "B-A0", "I-A0", "B-A1", "I-A1"]
UNK_IDX = 0


def get_dict():
    """(word_dict, verb_dict, label_dict) — reference: conll05.py:205."""
    word_dict = {"<w%d>" % i: i for i in range(_WORDS)}
    word_dict["bos"] = 0
    word_dict["eos"] = 1
    verb_dict = {"<v%d>" % i: i for i in range(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Deterministic stand-in word embedding table [len(word_dict), 32]."""
    return np.random.RandomState(0).randn(_WORDS, 32).astype(np.float32)


def _corpus(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(5, 15))
        sentence = ["<w%d>" % int(w)
                    for w in rng.randint(2, _WORDS, length)]
        verb_index = int(rng.randint(0, length))
        predicate = "<v%d>" % int(rng.randint(0, _VERBS))
        labels = []
        for i in range(length):
            if i == verb_index:
                labels.append("B-V")
            elif i == verb_index - 1:
                labels.append("B-A0")
            elif i == verb_index + 1:
                labels.append("B-A1")
            elif i == verb_index + 2:
                labels.append("I-A1")
            else:
                labels.append("O")
        yield sentence, predicate, labels


def _reader_creator(corpus, word_dict, predicate_dict, label_dict):
    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)

            def ctx(offset, default):
                i = verb_index + offset
                if 0 <= i < len(labels):
                    mark[i] = 1
                    return sentence[i]
                return default

            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            ctx_0 = ctx(0, sentence[verb_index])
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            c = lambda w: [word_dict.get(w, UNK_IDX)] * sen_len
            pred_idx = [predicate_dict.get(predicate, 0)] * sen_len
            label_idx = [label_dict[l] for l in labels]
            yield (word_idx, c(ctx_n2), c(ctx_n1), c(ctx_0), c(ctx_p1),
                   c(ctx_p2), pred_idx, mark, label_idx)

    return reader


def test():
    word_dict, verb_dict, label_dict = get_dict()
    return _reader_creator(lambda: _corpus(200, 1), word_dict, verb_dict,
                           label_dict)


def train():
    """Beyond-reference convenience (the reference trains on test() since
    the train set is not free); same format."""
    word_dict, verb_dict, label_dict = get_dict()
    return _reader_creator(lambda: _corpus(1000, 0), word_dict, verb_dict,
                           label_dict)
