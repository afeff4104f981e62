"""paddle.text.datasets (counterpart of paddle_tpu/text/datasets.py):
Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16, each a
map-style ``paddle.io.Dataset`` of host numpy rows. Nothing is downloaded:
each is the reference's deterministic synthetic fallback (class-conditional
templates shared across splits, fixed seeds), bitwise its rows, on which
models learn.
"""
import numpy as np

from ..io.dataset import Dataset

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]


def _check_mode(mode, allowed=("train", "test")):
    if mode not in allowed:
        raise ValueError(f"mode must be one of {allowed}, got {mode!r}")


class UCIHousing(Dataset):
    """(13-feature, price) regression rows (reference:
    text/datasets/uci_housing.py)."""

    def __init__(self, data_file=None, mode="train", download=True):
        _check_mode(mode)
        rng = np.random.RandomState(1)
        n = 404 if mode == "train" else 102
        self.x = rng.rand(n, 13).astype("float32")
        w = rng.rand(13, 1).astype("float32")
        self.y = (self.x @ w + 0.1 * rng.randn(n, 1)).astype("float32")

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class Imdb(Dataset):
    """Binary sentiment rows: (word-id int64 array, label) (reference:
    text/datasets/imdb.py)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        _check_mode(mode)
        from ..dataset import imdb as legacy

        reader = (legacy.train() if mode == "train" else legacy.test())()
        self.docs, self.labels = [], []
        for seq, label in reader:
            self.docs.append(np.asarray(seq, dtype=np.int64))
            self.labels.append(np.int64(label))
        self.word_idx = legacy.word_dict()

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram / sequence rows (reference:
    text/datasets/imikolov.py). Ids 0/1/2 are the reserved <s>/<e>/<unk>
    markers (the reference's word dict reserves the same three); word ids
    start at 3. 'SEQ' rows are <s> ... <e>-wrapped sentences; 'NGRAM'
    rows are window_size-grams over the wrapped sentence."""

    BOS, EOS, UNK = 0, 1, 2
    N_VOCAB = 2048

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        _check_mode(mode)
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError(f"data_type must be NGRAM or SEQ, "
                             f"got {data_type!r}")
        if data_type == "NGRAM" and window_size < 1:
            raise ValueError("NGRAM needs window_size >= 1")
        # bigram language with a fixed template transition table over the
        # word ids (3..V-1): the next word is predictable from the
        # current one, so LM perplexity actually drops during training
        n_words = self.N_VOCAB - 3
        trng = np.random.RandomState(13)
        table = trng.dirichlet(np.ones(n_words) * 0.02, size=n_words)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n_sent = 800 if mode == "train" else 160
        self.data = []
        for _ in range(n_sent):
            length = int(rng.randint(8, 24))
            sent = [int(rng.randint(n_words))]
            for _ in range(length - 1):
                sent.append(int(rng.choice(n_words, p=table[sent[-1]])))
            wrapped = [self.BOS] + [w + 3 for w in sent] + [self.EOS]
            if data_type == "NGRAM":
                for i in range(window_size - 1, len(wrapped)):
                    self.data.append(tuple(
                        np.int64(w)
                        for w in wrapped[i - window_size + 1:i + 1]))
            else:
                self.data.append(np.asarray(wrapped, dtype=np.int64))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """Rating rows (user_id, gender, age, job, movie_id, title_ids,
    categories, rating) (reference: text/datasets/movielens.py)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        _check_mode(mode)
        from ..dataset import movielens as legacy

        reader = (legacy.train() if mode == "train" else legacy.test())()
        self.rows = [tuple(np.asarray(f) for f in row) for row in reader]

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class _SyntheticTranslation(Dataset):
    """Shared body for WMT14/WMT16: parallel pairs from a fixed random
    token-to-token dictionary (src token i -> trg token perm[i]), so a
    seq2seq model can genuinely learn the mapping. Rows are
    (src_ids, trg_ids, trg_ids_next) int64 arrays with <s>=0, <e>=1,
    <unk>=2 following the reference layout."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, mode, dict_size, template_seed):
        n = {"train": 1000, "test": 200, "gen": 200, "dev": 200,
             "val": 200}[mode]
        self.dict_size = dict_size
        trng = np.random.RandomState(template_seed)
        perm = trng.permutation(dict_size - 3) + 3  # src i -> trg perm[i]
        rng = np.random.RandomState({"train": 0}.get(mode, 1))
        self.rows = []
        for _ in range(n):
            length = int(rng.randint(4, 16))
            src = rng.randint(3, dict_size, size=length)
            trg = perm[src - 3]
            src_ids = np.concatenate([[self.BOS], src, [self.EOS]])
            trg_ids = np.concatenate([[self.BOS], trg])
            trg_next = np.concatenate([trg, [self.EOS]])
            self.rows.append((src_ids.astype(np.int64),
                              trg_ids.astype(np.int64),
                              trg_next.astype(np.int64)))

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class WMT14(_SyntheticTranslation):
    """reference: text/datasets/wmt14.py (en→fr pairs)."""

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=True):
        _check_mode(mode, ("train", "test", "gen"))
        super().__init__(mode, 2048 if dict_size < 3 else dict_size,
                         template_seed=17)


class WMT16(_SyntheticTranslation):
    """reference: text/datasets/wmt16.py (en↔de pairs)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        _check_mode(mode, ("train", "test", "val"))
        size = max(src_dict_size, trg_dict_size)
        super().__init__(mode, 2048 if size < 3 else size,
                         template_seed=19)


class Conll05st(Dataset):
    """SRL rows (reference: text/datasets/conll05.py):
    (pred_idx, mark, word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
    label_ids) — here emitted in the reference's tuple order
    (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred, mark, label)."""

    WORD_VOCAB = 2048
    PRED_VOCAB = 64
    N_LABELS = 17

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train",
                 download=True):
        _check_mode(mode)
        # labels depend deterministically on (word bucket, distance to
        # predicate) so taggers can learn the structure
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 400 if mode == "train" else 80
        self.rows = []
        for _ in range(n):
            length = int(rng.randint(6, 20))
            words = rng.randint(0, self.WORD_VOCAB, size=length)
            pred_pos = int(rng.randint(0, length))
            pred = np.int64(words[pred_pos] % self.PRED_VOCAB)
            mark = (np.arange(length) == pred_pos).astype(np.int64)
            dist = np.abs(np.arange(length) - pred_pos)
            labels = ((words % 5) + np.minimum(dist, 2) * 5).astype(np.int64)
            ctx = [np.roll(words, s).astype(np.int64)
                   for s in (2, 1, 0, -1, -2)]
            self.rows.append((words.astype(np.int64), *ctx,
                              np.full(length, pred, dtype=np.int64), mark,
                              labels % self.N_LABELS))

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)
