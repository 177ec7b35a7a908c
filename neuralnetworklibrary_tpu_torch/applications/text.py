"""NLP: tokenization, LM and classification data, the AWD-LSTM language
model and text classifier, losses.

Counterpart of ``neuralnetworklibrary_tpu/applications/text.py`` (the
reference's Applications/Text.py):

- the tokenizer (fastai pre-rules and the spacy-like rule tokenizer),
  ``tokenize``, ``tokenize_mp`` and ``numericalize``, copied;
- ``TextDataset``, ``LanguageModelDataLoader`` and ``LanguageModelDataObj``
  with the same windows, offsets and reshuffle per (seed, epoch); pandas is
  imported only inside the csv constructors;
- the AWD-LSTM: ``locked_dropout``, ``WeightDropLSTM``,
  ``EmbeddingDropout``, ``LSTM_Encoder``, ``LanguageModelDecoder`` and
  ``LanguageModelNet``, with the flax parameter names (``enc.word_embed.
  weight``, ``enc.lstm_{i}.w_ih`` (I, 4H), ``w_hh`` (H, 4H), ``b_ih``,
  ``b_hh``), so carrying weights over from the JAX package is a renaming;
- ``RegSeqCrossEntropyLoss``, ``SeqCrossEntropyLoss``,
  ``LanguageModelAccuracy`` and ``predict_from_string``;
- the classifier: ``TextClassificationDataLoader`` (length-sorted groups,
  each batch padded to the smallest of a few bucket lengths that holds
  its longest text) and ``TextClassificationDataObj``,
  ``TextClassificationDecoder`` (attention pooling over time, then a
  ``FullyConnectedNet``), ``TextClassificationNet`` (a stateless encoder:
  every call starts from zero state), ``TextClassificationAccuracy``;
- ``load_torch_awd_lstm``, the wt103 converter.

The recurrence of ``WeightDropLSTM`` runs through ``ops.lstm_scan`` (the
CUDA kernels K6 and K7) on CUDA tensors, in training and in evaluation,
unless its ``lstm_kernel`` says otherwise; else it is the float32 step
loop that equals the JAX ``lax.scan``.  The encoder's carried (h, c) are
persistent buffers: detached, updated by every forward (train and eval),
saved with the model, re-zeroed when the batch size changes.  They start
at zero, where the JAX Learner's ``init`` leaves one window's state.

Dropout runs only in calls with ``train=True``.  Its masks come from a
generator on the input's device, seeded per forward by an int drawn from
the ``generator`` given (the Learner's seeded CPU generator), else from
torch's default one (the classifier head's ``F.dropout`` draws from
torch's default one); so they are statistically, not bitwise, the JAX
model's.  ``LanguageModelNet(fused_ce=True)`` with
:class:`FusedRegSeqCrossEntropyLoss` streams the vocabulary through
``ops.chunked_ce`` instead of building the logits.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import re
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.core.metrics import (
    masked_mean,
    seq_cross_entropy_loss,
)
from neuralnetworklibrary_tpu_torch.data.loader import Batch
from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal
from neuralnetworklibrary_tpu_torch.nn.layers import (
    FullyConnectedNet,
    device_generator,
    keep_mask,
    linear,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import (
    resolve_device,
    token_mask,
)
from neuralnetworklibrary_tpu_torch.ops.chunked_ce import chunked_softmax_ce
from neuralnetworklibrary_tpu_torch.ops.lstm_scan import lstm_scan
from neuralnetworklibrary_tpu_torch.utils.torch_convert import _np


def correct_foldername(p: str) -> str:
    return p if p.endswith("/") else p + "/"


# ---------------------------------------------------------------------------
# (1) Tokenization / numericalization (Text.py:28-122)
# ---------------------------------------------------------------------------

# spacy-compatible English splitting: contractions split off, hyphens
# between letters are infixes, numbers keep internal [,.:-] punctuation,
# ellipsis is one token, letter.letter compounds stay joined with the
# trailing period split off.  Golden fixtures:
# tests/fixtures/tokenizer_golden.json.
_CONTRACTION_RE = re.compile(r"(\w)(n't|'s|'m|'re|'ve|'ll|'d)\b")
# spacy tokenizer_exceptions that survive do_caps lowercasing
_SPECIAL_CASES = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "wanna": ["wan", "na"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
    "outta": ["out", "ta"],
}
# abbreviations that keep their trailing period, as spacy's English
# tokenizer_exceptions do, restricted to forms unambiguous after lowercasing
_ABBREV = r"(?:e\.g|i\.e|a\.m|p\.m|etc|mr|mrs|ms|dr|prof|vs|jr|sr|approx)"
_TOKEN_RE = re.compile(
    r"_[a-z]+_"                    # specials like _unk_, _bos_
    r"|[\w.+\-]+@[\w\-]+(?:\.[\w\-]+)+"   # emails as whole tokens
    r"|(?:n't|'s|'m|'re|'ve|'ll|'d)(?![a-z])"   # pre-split contractions
    r"|\.\.\."                     # ellipsis (exactly 3; 4+ became tk_rep)
    + r"|" + _ABBREV + r"\.(?!\w)"  # known abbreviations keep the period
    + r"|\d+(?:[,.:\-]\d+)*"       # numbers with internal punctuation
    r"|\w+(?:\.\w+)+"              # period compounds (u.s a.b)
    r"|\w+"                        # plain words (hyphens split off)
    r"|[^\w\s]"                    # single punctuation marks
)


class Tokenizer:
    """fastai-style pre-rules + rule tokenizer (Text.py:28-75).

    Pre-rules: <br/> -> newline; char runs of >= 4 -> 'tk_rep N c'; word
    runs of >= 4 -> 'tk_wrep N w'; ALLCAPS words -> 't_up word'; '/' and
    '#' padded with spaces; whitespace squeezed.
    """

    re_br = re.compile(r"<\s*br\s*/?>", re.IGNORECASE)
    re_rep = re.compile(r"(\S)(\1{3,})")
    re_word_rep = re.compile(r"(\b\w+\W+)(\1{3,})")

    def sub_br(self, x):
        return self.re_br.sub("\n", x)

    @staticmethod
    def replace_rep(m):
        c, cc = m.groups()
        return f" tk_rep {len(cc) + 1} {c} "

    @staticmethod
    def replace_wrep(m):
        c, cc = m.groups()
        return f" tk_wrep {len(cc.split()) + 1} {c} "

    @staticmethod
    def do_caps(ss):
        res = []
        for s in re.findall(r"\w+|\W+", ss):
            res += ([" t_up ", s.lower()] if (s.isupper() and len(s) > 2)
                    else [s.lower()])
        return "".join(res)

    def base_tok(self, x):
        x = _CONTRACTION_RE.sub(r"\1 \2", x)
        out = []
        for raw in _TOKEN_RE.findall(x):
            special = _SPECIAL_CASES.get(raw)
            if special is not None:
                out += special
            else:
                out.append(raw)
        return out

    def proc_text(self, s: str) -> list:
        s = self.re_rep.sub(Tokenizer.replace_rep, s)
        s = self.re_word_rep.sub(Tokenizer.replace_wrep, s)
        s = Tokenizer.do_caps(s)
        s = re.sub(r"([/#])", r" \1 ", s)
        s = re.sub(" {2,}", " ", s)
        return self.base_tok(self.sub_br(s))


def tokenize(ss: Sequence[str]) -> list:
    """Tokenize a list of texts (Text.py:77-83)."""
    tok = Tokenizer()
    return [tok.proc_text(s) for s in ss]


def tokenize_mp(ss: Sequence[str], ncpus: Optional[int] = None) -> list:
    """Multiprocess tokenization (Text.py:85-93); spawned workers."""
    if ncpus is None:
        ncpus = max(1, (os.cpu_count() or 2) - 2)
    if ncpus <= 1 or len(ss) < 64:
        return tokenize(ss)
    n, m = len(ss), int(np.ceil(len(ss) / ncpus))
    chunks = [ss[i:min(i + m, n)] for i in range(0, n, m)]
    with ProcessPoolExecutor(
            ncpus, mp_context=multiprocessing.get_context("spawn")) as ex:
        return sum(ex.map(tokenize, chunks), [])


def numericalize(ss, max_vocab=60000, min_freq=6, stoi=None):
    """Token lists -> int lists + vocab (Text.py:95-122): cap at max_vocab
    by frequency, drop tokens rarer than min_freq, specials
    ['_unk_', '_pad_', '_bos_', '_eos_'] at ids 0-3, unknown -> 0."""
    if stoi is None:
        counts = collections.Counter(
            tok for s in ss for tok in s).most_common(max_vocab)
        tokens = [tok for tok, c in counts if c >= min_freq]
        stoi = {tok: i for i, tok in enumerate(
            ["_unk_", "_pad_", "_bos_", "_eos_"] + tokens)}
    ss_numeric = [[stoi.get(tok, 0) for tok in s] for s in ss]
    return ss_numeric, stoi


# ---------------------------------------------------------------------------
# (2) Datasets and data objects (Text.py:127-330)
# ---------------------------------------------------------------------------


class TextDataset:
    """Tokenized + numericalized text dataset (Text.py:127-229)."""

    def __init__(self, texts, labels, stoi=None, reverse=False, ncpus=None):
        toks = tokenize_mp(list(texts), ncpus)
        self.texts, self.stoi = numericalize(toks, stoi=stoi)
        if reverse:
            self.texts = [list(reversed(t)) for t in self.texts]
        self.num_tokens = sum(len(t) for t in self.texts)
        unique_labels = sorted(set(labels))
        self.label_dict = {lab: i for i, lab in enumerate(unique_labels)}
        self.labels = [self.label_dict[lab] for lab in labels]

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, idx):
        return self.texts[idx], self.labels[idx]

    def split_train_val(self, val_frac=0.2, seed=0):
        """Random split sharing the vocab (Text.py:157-179)."""
        idxs = list(range(len(self.texts)))
        train_idxs, val_idxs = SplitTrainVal(idxs, val_frac=val_frac,
                                             seed=seed)
        val = object.__new__(TextDataset)
        val.stoi, val.label_dict = self.stoi, self.label_dict
        val.texts = [self.texts[i] for i in val_idxs]
        val.labels = [self.labels[i] for i in val_idxs]
        val.num_tokens = sum(len(t) for t in val.texts)
        self.texts = [self.texts[i] for i in train_idxs]
        self.labels = [self.labels[i] for i in train_idxs]
        self.num_tokens = sum(len(t) for t in self.texts)
        return self, val

    @classmethod
    def from_csv(cls, csv_file, text_col, label_col=None, stoi=None,
                 reverse=False):
        """One text (and optional label) per csv row (Text.py:181-189)."""
        import pandas as pd

        df = pd.read_csv(csv_file)
        labels = list(df[label_col]) if label_col else [0] * len(df)
        return cls(list(df[text_col]), labels, stoi, reverse)

    @classmethod
    def from_text_files(cls, folder, labels, stoi=None, reverse=False):
        """From .txt files, optionally in labeled subfolders
        (Text.py:191-229)."""
        folder = correct_foldername(folder)
        texts, texts_labels = [], []
        if labels is None:
            for fn in sorted(os.listdir(folder)):
                if fn.endswith(".txt"):
                    with open(folder + fn) as f:
                        texts.append(f.read())
            texts_labels = [0] * len(texts)
        else:
            if isinstance(labels, str):
                labels = os.listdir(folder)
            for lab in sorted(labels):
                for fn in sorted(os.listdir(folder + lab)):
                    if fn.endswith(".txt"):
                        with open(folder + lab + "/" + fn) as f:
                            texts.append(f.read())
                        texts_labels.append(lab)
        return cls(texts, texts_labels, stoi, reverse)


class LanguageModelDataLoader:
    """Concat-and-window LM loader (Text.py:231-290), static shapes.

    All texts concatenate into one stream, reshaped (bs, seqlen); windows
    of exactly (bs, bptt) are yielded with y = x shifted by one.  When
    ``random``: text order reshuffles and the window start offset is drawn
    from [0, bptt) each epoch, from ``np.random.default_rng((seed,
    epoch))``, as in the JAX loader.
    """

    def __init__(self, ds, bs, bptt, random=True, seed=0):
        self.ds, self.bs, self.bptt, self.random = ds, bs, bptt, random
        self.seed = seed
        self.epoch = 0
        self.seqlen = ds.num_tokens // bs - 1
        if self.seqlen < bptt:
            raise ValueError("dataset too small for bs*bptt windows")
        self._concat(offset_epoch=0)

    def _concat(self, offset_epoch):
        rng = np.random.default_rng((self.seed, offset_epoch))
        idxs = np.arange(len(self.ds.texts))
        if self.random:
            rng.shuffle(idxs)
        ntoks = self.bs * (self.seqlen + 1)
        stream = np.fromiter(
            (tok for i in idxs for tok in self.ds.texts[int(i)]),
            dtype=np.int32, count=self.ds.num_tokens)[:ntoks]
        self.data = stream.reshape(self.bs, self.seqlen + 1)
        # bounded so every epoch yields exactly len(self) batches
        hi = min(self.bptt, self.seqlen - len(self) * self.bptt + 1)
        self.offset = int(rng.integers(0, max(1, hi))) if self.random else 0

    def __len__(self):
        if self.random:
            return max(1, (self.seqlen - (self.bptt - 1)) // self.bptt)
        return self.seqlen // self.bptt

    def _batch(self, s) -> Batch:
        x = self.data[:, s:s + self.bptt]
        y = self.data[:, s + 1:s + self.bptt + 1]
        return Batch(xs=(x,), y=y, mask=np.ones(self.bs, np.float32),
                     n_valid=self.bs)

    def peek(self) -> Batch:
        return self._batch(0)

    def __iter__(self):
        for b in range(len(self)):
            yield self._batch(self.offset + b * self.bptt)
        self.epoch += 1
        if self.random:
            self._concat(self.epoch)


class LanguageModelDataObj:
    """LM datasets + loaders (Text.py:292-330)."""

    def __init__(self, train_ds, val_ds, test_ds, bs, bptt, seed=0):
        self.bs, self.bptt = bs, bptt
        self.stoi, self.target_type = train_ds.stoi, "lang_model"
        self.train_ds, self.val_ds, self.test_ds = train_ds, val_ds, test_ds
        self.train_dl = LanguageModelDataLoader(train_ds, bs, bptt, True,
                                                seed)
        self.val_dl = LanguageModelDataLoader(val_ds, bs, bptt, False)
        if test_ds:
            self.test_dl = LanguageModelDataLoader(test_ds, bs, bptt, False)

    @classmethod
    def from_csv(cls, bs, bptt, csv_train, csv_val=None, csv_test=None,
                 text_col="text", reverse=False, seed=0):
        train_ds = TextDataset.from_csv(csv_train, text_col, None, None,
                                        reverse)
        stoi = train_ds.stoi
        if csv_val:
            val_ds = TextDataset.from_csv(csv_val, text_col, None, stoi,
                                          reverse)
        else:
            train_ds, val_ds = train_ds.split_train_val(seed=seed)
        test_ds = (TextDataset.from_csv(csv_test, text_col, None, stoi,
                                        reverse) if csv_test else None)
        return cls(train_ds, val_ds, test_ds, bs, bptt, seed)

    @classmethod
    def from_folders(cls, bs, bptt, labels, train, val=None, test=None,
                     reverse=False, seed=0):
        train_ds = TextDataset.from_text_files(train, labels, None, reverse)
        stoi = train_ds.stoi
        if val:
            val_ds = TextDataset.from_text_files(val, labels, stoi, reverse)
        else:
            train_ds, val_ds = train_ds.split_train_val(seed=seed)
        test_ds = (TextDataset.from_text_files(test, labels, stoi, reverse)
                   if test else None)
        return cls(train_ds, val_ds, test_ds, bs, bptt, seed)


def _bucket_len(n, buckets):
    """The smallest bucket length >= n, else the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TextClassificationDataLoader:
    """Length-bucketed classification loader (TextLengthSampler +
    TextLengthCollater, Text.py:334-389), as the JAX loader:

    texts sort by length, longest first; consecutive groups of bs*bpg
    texts are the units of shuffling (with ``random``, every group but the
    first, the longest texts, changes places, and each group's texts are
    shuffled, from ``np.random.default_rng((seed, epoch))``).  A batch
    pads its texts at the end with ``pad_token`` to the smallest bucket
    length that holds its longest text (texts beyond the last bucket are
    cut to it), and a short batch repeats its last index, masked, to keep
    ``bs`` rows.
    """

    def __init__(self, ds, bs, pad_token, bpg=10, random=False, seed=0,
                 buckets=(64, 128, 256, 512, 1024, 2048, 4096)):
        self.ds, self.bs, self.pad_token = ds, bs, pad_token
        self.random, self.seed = random, seed
        self.buckets = tuple(buckets)
        self.epoch = 0
        order = sorted(range(len(ds)), key=lambda i: len(ds.texts[i]),
                       reverse=True)
        self.order = order
        group_sz = bs * bpg
        self.groups = [order[i:i + group_sz]
                       for i in range(0, len(order), group_sz)]

    def __len__(self):
        return sum(-(-len(g) // self.bs) for g in self.groups)

    def _make_batch(self, idxs) -> Batch:
        n_valid = len(idxs)
        idxs = list(idxs) + [idxs[-1]] * (self.bs - n_valid)
        texts = [self.ds.texts[i] for i in idxs]
        labels = np.asarray([self.ds.labels[i] for i in idxs], np.int64)
        maxlen = max(1, max(len(t) for t in texts))
        L = _bucket_len(maxlen, self.buckets)
        x = np.full((self.bs, L), self.pad_token, np.int32)
        for r, t in enumerate(texts):
            t = t[:L]
            x[r, :len(t)] = t
        mask = np.zeros(self.bs, np.float32)
        mask[:n_valid] = 1.0
        return Batch(xs=(x,), y=labels, mask=mask, n_valid=n_valid)

    def peek(self) -> Batch:
        return self._make_batch(self.groups[0][:self.bs])

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        groups = [list(g) for g in self.groups]
        if self.random:
            rest = groups[1:]
            rng.shuffle(rest)
            groups = [groups[0]] + rest
            for g in groups:
                rng.shuffle(g)
        for g in groups:
            for i in range(0, len(g), self.bs):
                yield self._make_batch(g[i:i + self.bs])
        self.epoch += 1


class TextClassificationDataObj:
    """Classification datasets + bucketed loaders (Text.py:391-438); the
    train loader shuffles, the others keep the sorted order."""

    def __init__(self, train_ds, val_ds, test_ds, bs, bpg=10, seed=0):
        self.bs, self.stoi = bs, train_ds.stoi
        self.target_type = "text_classify"
        self.train_ds, self.val_ds, self.test_ds = train_ds, val_ds, test_ds
        pad = self.stoi["_pad_"]
        self.train_dl = TextClassificationDataLoader(train_ds, bs, pad, bpg,
                                                     True, seed)
        self.val_dl = TextClassificationDataLoader(val_ds, bs, pad, bpg,
                                                   False)
        if test_ds:
            self.test_dl = TextClassificationDataLoader(test_ds, bs, pad,
                                                        bpg, False)

    @classmethod
    def from_csv(cls, bs, csv_train, csv_val=None, csv_test=None,
                 text_col="text", label_col="label", reverse=False,
                 stoi=None, seed=0):
        train_ds = TextDataset.from_csv(csv_train, text_col, label_col, stoi,
                                        reverse)
        stoi = train_ds.stoi
        if csv_val:
            val_ds = TextDataset.from_csv(csv_val, text_col, label_col, stoi,
                                          reverse)
        else:
            train_ds, val_ds = train_ds.split_train_val(seed=seed)
        test_ds = (TextDataset.from_csv(csv_test, text_col, label_col, stoi,
                                        reverse) if csv_test else None)
        return cls(train_ds, val_ds, test_ds, bs, seed=seed)

    @classmethod
    def from_folders(cls, bs, labels, train, val=None, test=None,
                     reverse=False, stoi=None, seed=0):
        train_ds = TextDataset.from_text_files(train, labels, stoi, reverse)
        stoi = train_ds.stoi
        if val:
            val_ds = TextDataset.from_text_files(val, labels, stoi, reverse)
        else:
            train_ds, val_ds = train_ds.split_train_val(seed=seed)
        test_ds = (TextDataset.from_text_files(test, labels, stoi, reverse)
                   if test else None)
        return cls(train_ds, val_ds, test_ds, bs, seed=seed)


# ---------------------------------------------------------------------------
# (3) Models (Text.py:441-651)
# ---------------------------------------------------------------------------


def locked_dropout(x, rate, train, generator=None):
    """Variational dropout: one (B, 1, D) mask shared across time
    (LockedDropout, Text.py:443-452)."""
    if not train or rate == 0.0:
        return x
    keep = keep_mask((x.shape[0], 1, x.shape[2]), rate, x, generator)
    return x * keep / (1.0 - rate)


class WeightDropLSTM(nn.Module):
    """Single-layer LSTM with DropConnect on the recurrent weights
    (WeightDropLSTM1, Text.py:477-513).

    Parameters in the flax layout: w_ih (I, 4H) and w_hh (H, 4H) for
    right-multiplication, b_ih and b_hh (4H,), gate order [i, f, g, o],
    initialised U(-1/sqrt(H), 1/sqrt(H)).  The input projection for all
    steps is one product hoisted out of the recurrence.

    ``lstm_kernel``: None (auto) runs the recurrence through
    ``ops.lstm_scan`` exactly when the input lies on a CUDA device (the
    kernels K6/K7), in training and in evaluation; True always through
    ``lstm_scan`` (its plain versions on the CPU); False through the float32
    step loop that equals the JAX ``lax.scan``.  Read at every call.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 weight_drop: float = 0.0,
                 lstm_kernel: Optional[bool] = None, device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_drop = weight_drop
        self.lstm_kernel = lstm_kernel
        k = 1.0 / np.sqrt(hidden_size)
        G = 4 * hidden_size

        def uniform(*shape):
            return nn.Parameter(torch.empty(*shape, device=device)
                                .uniform_(-k, k))

        self.w_ih = uniform(input_size, G)
        self.w_hh = uniform(hidden_size, G)
        self.b_ih = uniform(G)
        self.b_hh = uniform(G)

    def forward(self, x, h0, c0, train: bool = False, generator=None):
        """x (B, T, I), h0/c0 (B, H) -> (ys (B, T, H), hT, cT)."""
        w_hh = self.w_hh
        if train and self.weight_drop > 0.0:
            w_hh = w_hh * keep_mask(w_hh.shape, self.weight_drop, w_hh,
                                generator) / (1.0 - self.weight_drop)
        xp = x @ self.w_ih + self.b_ih + self.b_hh      # (B, T, 4H)
        use_kernel = (x.is_cuda if self.lstm_kernel is None
                      else bool(self.lstm_kernel))
        if use_kernel:
            return lstm_scan(xp, w_hh, h0, c0)
        h, c = h0, c0
        ys = []
        for t in range(xp.shape[1]):
            i, f, g, o = (xp[:, t] + h @ w_hh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1), h, c


class EmbeddingDropout(nn.Module):
    """Word embedding with whole-row dropout and locked output dropout
    (Text.py:454-475); weight U(-0.1, 0.1), pad row zero.  Returns the
    embedded tokens and the raw weight (the decoder's tied weight)."""

    def __init__(self, vocab_size: int, emb_dim: int, drop1: float,
                 drop2: float, pad_token: int, device=None):
        super().__init__()
        self.drop1, self.drop2 = drop1, drop2
        w = torch.empty(vocab_size, emb_dim, device=device).uniform_(-0.1,
                                                                     0.1)
        w[pad_token] = 0.0
        self.weight = nn.Parameter(w)

    def forward(self, x, train: bool = False, generator=None):
        weight = self.weight
        if train and self.drop1 > 0.0:
            weight = weight * keep_mask((weight.shape[0], 1), self.drop1,
                                    weight, generator) / (1.0 - self.drop1)
        out = weight[x]
        out = locked_dropout(out, self.drop2, train, generator)
        return out, self.weight


class LSTM_Encoder(nn.Module):
    """Embedding and ``num_layers`` weight-dropped LSTMs (Text.py:515-551);
    layer i maps sizes[i] to sizes[i + 1], sizes = [emb, hidden, ...,
    hidden, emb].

    ``stateful=True`` carries (h, c) across windows in persistent buffers
    ``h{i}``/``c{i}`` (B, H): detached (truncated BPTT), replaced by every
    forward in training and in evaluation, saved in the state dict, and
    re-zeroed when a batch of another size arrives; :meth:`reset_carry`
    zeroes them.  ``stateful=False`` starts every call from zeros.
    """

    def __init__(self, vocab_size: int, emb_dim: int = 400,
                 hidden_size: int = 1150, num_layers: int = 3,
                 pad_token: int = 1,
                 drops: tuple = (0.05, 0.25, 0.2, 0.15),
                 stateful: bool = True, lstm_kernel: Optional[bool] = None,
                 device=None):
        super().__init__()
        self.num_layers, self.stateful = num_layers, stateful
        emb_drop1, emb_drop2, weight_drop, self.hidden_drop = drops
        self.word_embed = EmbeddingDropout(vocab_size, emb_dim, emb_drop1,
                                           emb_drop2, pad_token, device)
        sizes = [emb_dim] + [hidden_size] * (num_layers - 1) + [emb_dim]
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", WeightDropLSTM(
                sizes[i], sizes[i + 1], weight_drop, lstm_kernel, device))
            if stateful:
                for n in ("h", "c"):
                    self.register_buffer(f"{n}{i}", torch.zeros(
                        0, sizes[i + 1], device=device))

    def lstms(self):
        return [getattr(self, f"lstm_{i}") for i in range(self.num_layers)]

    def carry(self) -> list:
        """The carried state as [(h0, c0), (h1, c1), ...]."""
        return [(getattr(self, f"h{i}"), getattr(self, f"c{i}"))
                for i in range(self.num_layers)]

    def set_carry(self, carry):
        for i, (h, c) in enumerate(carry):
            setattr(self, f"h{i}", h)
            setattr(self, f"c{i}", c)

    def reset_carry(self, batch_size: Optional[int] = None):
        """Zero the carried state (at ``batch_size`` rows, default the
        current number)."""
        carry = []
        for h, _ in self.carry():
            rows = h.shape[0] if batch_size is None else batch_size
            carry.append((h.new_zeros(rows, h.shape[1]),
                          h.new_zeros(rows, h.shape[1])))
        self.set_carry(carry)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a checkpoint's carry may have another batch size: take its shape
        for i in range(self.num_layers if self.stateful else 0):
            for n in ("h", "c"):
                saved = state_dict.get(f"{prefix}{n}{i}")
                own = getattr(self, f"{n}{i}")
                if saved is not None and saved.shape != own.shape:
                    setattr(self, f"{n}{i}", own.new_empty(saved.shape))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, train: bool = False, generator=None,
                return_embed_weight: bool = False):
        B = x.shape[0]
        x, emb_weight = self.word_embed(x, train, generator)
        if self.stateful and self.h0.shape[0] != B:
            self.reset_carry(B)
        for i, layer in enumerate(self.lstms()):
            if self.stateful:
                h0, c0 = getattr(self, f"h{i}"), getattr(self, f"c{i}")
            else:
                h0 = c0 = x.new_zeros(B, layer.hidden_size)
            x, hT, cT = layer(x, h0, c0, train, generator)
            if self.stateful:   # detach (Text.py:547-550)
                setattr(self, f"h{i}", hT.detach().float())
                setattr(self, f"c{i}", cT.detach().float())
            x = locked_dropout(x, self.hidden_drop, train, generator)
        if return_embed_weight:
            return x, emb_weight
        return x


class _LSTMKernelSwitch:
    """``lstm_kernel`` of a net over ``self.enc`` (an :class:`LSTM_Encoder`):
    read from its first layer, set on every layer."""

    @property
    def lstm_kernel(self) -> Optional[bool]:
        return self.enc.lstm_0.lstm_kernel

    @lstm_kernel.setter
    def lstm_kernel(self, value: Optional[bool]):
        for layer in self.enc.lstms():
            layer.lstm_kernel = value


class LanguageModelDecoder(nn.Module):
    """Tied-weight linear decoder (Text.py:553-573): logits =
    drop(enc_out) @ weight^T; the tied weight is passed at call time."""

    def __init__(self, drop: float = 0.1):
        super().__init__()
        self.drop = drop

    def forward(self, enc_out, tied_weight, train: bool = False,
                generator=None, return_hidden: bool = False):
        """``return_hidden``: the (dropped) decoder input instead of the
        logits, for the chunked CE (same dropout as the logits path)."""
        h = locked_dropout(enc_out, self.drop, train, generator)
        return h if return_hidden else F.linear(h, tied_weight)


class LanguageModelNet(_LSTMKernelSwitch, nn.Module):
    """LSTM encoder + tied linear decoder (Text.py:611-651).

    Returns (logits (B, T, V), enc_out); the encoder output feeds the AR/TAR
    terms of :class:`RegSeqCrossEntropyLoss`.  Layer groups for the
    Learner: [lstms, word_embed (= head, the tied decoder)].  Dropout rates
    are ``enc_drops`` and ``dec_drop`` times ``drop_scaling``.
    ``lstm_kernel`` (see :class:`WeightDropLSTM`) reaches every layer and
    may be set on a built model.  ``fused_ce`` returns (h, tied weight,
    enc_out) for :class:`FusedRegSeqCrossEntropyLoss`, which streams the
    vocabulary (``ops.chunked_ce``) instead of building the logits.
    ``device`` defaults to cuda (see ``nn.transformer.resolve_device``).
    """

    head_prefixes = ("enc/word_embed",)

    def __init__(self, vocab_size: int, pad_token: int = 1,
                 enc_drops: tuple = (0.05, 0.25, 0.2, 0.15),
                 dec_drop: float = 0.1, drop_scaling: float = 0.7,
                 emb_dim: int = 400, hidden_size: int = 1150,
                 num_layers: int = 3, fused_ce: bool = False,
                 lstm_kernel: Optional[bool] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.fused_ce = fused_ce
        self.vocab_size, self.pad_token = vocab_size, pad_token
        self.enc_drops = tuple(enc_drops)
        self.emb_dim, self.hidden_size = emb_dim, hidden_size
        self.num_layers = num_layers
        drops = tuple(d * drop_scaling for d in enc_drops)
        self.enc = LSTM_Encoder(vocab_size, emb_dim, hidden_size, num_layers,
                                pad_token, drops, stateful=True,
                                lstm_kernel=lstm_kernel, device=dev)
        self.dec = LanguageModelDecoder(dec_drop * drop_scaling)

    @property
    def layer_group_prefixes(self):
        lstms = tuple(f"enc/lstm_{i}" for i in range(self.num_layers))
        return (lstms, ("enc/word_embed",))

    def reset_carry(self, batch_size: Optional[int] = None):
        self.enc.reset_carry(batch_size)

    def forward(self, x, train: bool = False, generator=None):
        """x (B, T) token ids.  ``train=True`` applies dropout, with masks
        from a device generator seeded by one draw from ``generator``."""
        gen = device_generator(generator, x.device) if train else None
        enc_out, tied = self.enc(x, train, gen, return_embed_weight=True)
        if self.fused_ce:
            return (self.dec(enc_out, tied, train, gen, return_hidden=True),
                    tied, enc_out)
        return self.dec(enc_out, tied, train, gen), enc_out

    @classmethod
    def from_dataobj(cls, data, enc_drops=(0.05, 0.25, 0.2, 0.15),
                     dec_drop=0.1, drop_scaling=0.7, **kw):
        return cls(vocab_size=len(data.stoi), pad_token=data.stoi["_pad_"],
                   enc_drops=tuple(enc_drops), dec_drop=dec_drop,
                   drop_scaling=drop_scaling, **kw)


class TextClassificationDecoder(nn.Module):
    """Attention-pooled classifier head (Text.py:575-609): scores
    ``attn2(relu(attn1(enc_out)))``, a softmax over time, pads masked out
    and the weights renormalised (by max(sum, 1e-12)), the weighted sum of
    ``enc_out`` into a ``FullyConnectedNet`` [emb_dim, *fc_layer_sizes,
    num_classes].  The softmax and the pooling run in float32 under
    autocast."""

    def __init__(self, num_classes: int, attn_size: int = 100,
                 fc_layer_sizes: tuple = (100,),
                 fc_drops: tuple = (0.25, 0.25), emb_dim: int = 400,
                 pad_token: int = 1, device=None):
        super().__init__()
        self.pad_token = pad_token
        self.attn1 = linear(emb_dim, attn_size, device=device)
        self.attn2 = linear(attn_size, 1, device=device)
        sizes = (emb_dim,) + tuple(fc_layer_sizes) + (num_classes,)
        self.fc = FullyConnectedNet(sizes, fc_drops, device=device)

    def forward(self, enc_in, enc_out, train: bool = False,
                return_attn: bool = False):
        a = self.attn2(F.relu(self.attn1(enc_out)))[..., 0]    # (B, T)
        with torch.autocast(enc_out.device.type, enabled=False):
            a = torch.softmax(a.float(), dim=1)
            a = a * (enc_in != self.pad_token).float()
            a = a / torch.clamp(a.sum(1, keepdim=True), min=1e-12)
            combined = (a[..., None] * enc_out.float()).sum(1)  # (B, E)
        out = self.fc(combined, train)
        if return_attn:
            return out, a
        return out


class TextClassificationNet(_LSTMKernelSwitch, nn.Module):
    """AWD-LSTM encoder + attention classifier head (Text.py:704-751).

    The encoder is stateless: every call starts from zero (h, c), whatever
    the batch's length, so nothing carries over between batches or buckets.
    Returns (logits (B, num_classes), enc_out), or with ``return_attn``
    (logits, enc_out, attention (B, T)).  Layer groups for the Learner:
    [lstms, word_embed, dec (= head)].  ``lstm_kernel`` as in
    :class:`LanguageModelNet`; ``device`` defaults to cuda.
    """

    head_prefixes = ("dec",)

    def __init__(self, vocab_size: int, num_classes: int, pad_token: int = 1,
                 attn_size: int = 100,
                 enc_drops: tuple = (0.05, 0.25, 0.2, 0.15),
                 drop_scaling: float = 0.7, fc_layer_sizes: tuple = (100,),
                 fc_drops: tuple = (0.25, 0.25), emb_dim: int = 400,
                 hidden_size: int = 1150, num_layers: int = 3,
                 lstm_kernel: Optional[bool] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size, self.num_classes = vocab_size, num_classes
        self.pad_token, self.num_layers = pad_token, num_layers
        drops = tuple(d * drop_scaling for d in enc_drops)
        self.enc = LSTM_Encoder(vocab_size, emb_dim, hidden_size, num_layers,
                                pad_token, drops, stateful=False,
                                lstm_kernel=lstm_kernel, device=dev)
        self.dec = TextClassificationDecoder(
            num_classes, attn_size, tuple(fc_layer_sizes), tuple(fc_drops),
            emb_dim, pad_token, device=dev)

    @property
    def layer_group_prefixes(self):
        lstms = tuple(f"enc/lstm_{i}" for i in range(self.num_layers))
        return (lstms, ("enc/word_embed",), ("dec",))

    def forward(self, x, train: bool = False, generator=None,
                return_attn: bool = False):
        """x (B, T) token ids, padded with ``pad_token`` at the end."""
        gen = device_generator(generator, x.device) if train else None
        enc_out = self.enc(x, train, gen)
        out = self.dec(x, enc_out, train, return_attn)
        if return_attn:
            return out[0], enc_out, out[1]
        return out, enc_out

    @classmethod
    def from_language_model(cls, learner, num_classes, **kw):
        """A classifier with the LM Learner's encoder widths, drops and
        vocabulary, and ``transfer(model)``, which copies the LM's encoder
        weights as they are now (``enc.*``) into ``model`` in place and
        returns it (Text.py:726-732)."""
        lm = learner.model
        kw.setdefault("device", next(lm.parameters()).device)
        model = cls(vocab_size=lm.vocab_size, pad_token=lm.pad_token,
                    num_classes=num_classes, enc_drops=lm.enc_drops,
                    emb_dim=lm.emb_dim, hidden_size=lm.hidden_size,
                    num_layers=lm.num_layers, **kw)
        lm_enc = {n: p.detach().clone() for n, p in
                  lm.enc.named_parameters()}

        def transfer(clf):
            with torch.no_grad():
                for n, p in clf.enc.named_parameters():
                    p.copy_(lm_enc[n])
            return clf

        return model, transfer


# ---------------------------------------------------------------------------
# (4) Losses and metrics (Text.py:754-808)
# ---------------------------------------------------------------------------


class RegSeqCrossEntropyLoss:
    """CE + AR/TAR activation regularizers on the encoder output
    (Text.py:756-777): alpha * mean(enc^2) + beta * mean((enc_t+1 -
    enc_t)^2)."""

    def __init__(self, alpha=2.0, beta=1.0):
        self.alpha, self.beta = alpha, beta

    def __call__(self, outputs, target, mask=None):
        preds, enc_out = outputs[0], outputs[1]
        loss = seq_cross_entropy_loss(preds, target, mask)
        if self.alpha > 0:
            loss = loss + self.alpha * enc_out.square().mean()
        if self.beta > 0:
            loss = loss + self.beta * (enc_out[:, 1:]
                                       - enc_out[:, :-1]).square().mean()
        return loss


class FusedRegSeqCrossEntropyLoss:
    """:class:`RegSeqCrossEntropyLoss` for ``LanguageModelNet(fused_ce=
    True)`` (JAX text.py:792): outputs are (h, tied weight, enc_out) and
    the CE streams the vocabulary in ``chunk`` rows (``ops.chunked_ce``),
    so the (B, T, V) logits are never built."""

    def __init__(self, alpha=2.0, beta=1.0, chunk: int = 8192):
        self.alpha, self.beta = alpha, beta
        self.chunk = chunk

    def __call__(self, outputs, target, mask=None):
        h, tied, enc_out = outputs
        loss = chunked_softmax_ce(h, tied, target, token_mask(target, mask),
                                  self.chunk)
        if self.alpha > 0:
            loss = loss + self.alpha * enc_out.square().mean()
        if self.beta > 0:
            loss = loss + self.beta * (enc_out[:, 1:]
                                       - enc_out[:, :-1]).square().mean()
        return loss


class SeqCrossEntropyLoss:
    """Unregularized sequence CE (Text.py:779-788), the quantity reported
    as val loss for LMs: the softmax CE of every token of the valid rows,
    averaged.  Tuple outputs unwrap to their first element."""

    def __call__(self, outputs, target, mask=None):
        return seq_cross_entropy_loss(outputs, target, mask)


class LanguageModelAccuracy:
    """Token accuracy ignoring the 4 special tokens (Text.py:791-799)."""

    def __call__(self, preds, target, mask=None):
        preds = preds[0] if isinstance(preds, tuple) else preds
        preds = preds.clone()
        preds[..., :4] = -torch.inf
        correct = (preds.argmax(dim=-1) == target).float()
        return masked_mean(correct, mask)


class TextClassificationAccuracy:
    """Class accuracy (Text.py:801-808)."""

    def __call__(self, preds, target, mask=None):
        preds = preds[0] if isinstance(preds, tuple) else preds
        return masked_mean((preds.argmax(dim=-1) == target).float(), mask)


# ---------------------------------------------------------------------------
# (5) Generation + pretrained weight conversion
# ---------------------------------------------------------------------------


@torch.no_grad()
def predict_from_string(learner, s: str, n: int, k: int = 5, seed: int = 0):
    """Top-k sampled continuation of a prompt (Text.py:655-676): feed the
    tokens one at a time through a batch-1 carry, then sample each next
    token from the renormalized top k (special tokens excluded) with
    ``np.random.default_rng(seed)``.

    The batch-1 carry starts at zero and is the model's own buffers for the
    length of the call; the carry the model had is restored after.  (The
    JAX function starts from the state its ``model.init`` leaves.)
    """
    model, stoi = learner.model, learner.data.stoi
    itos = {i: t for t, i in stoi.items()}
    toks = numericalize(tokenize([s]), stoi=stoi)[0][0]
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    saved = model.enc.carry()
    was_training = model.training
    model.eval()
    model.reset_carry(1)

    def step(tok):
        logits, _ = model(torch.tensor([[tok]], device=dev), train=False)
        return logits[0, -1].float()

    try:
        logits = None
        for t in toks:
            logits = step(t)
        out = list(toks)
        for _ in range(n):
            probs = torch.softmax(logits, dim=-1).cpu().numpy()
            probs[:4] = 0  # special tokens
            top = np.argsort(probs)[-k:]
            p = probs[top] / probs[top].sum()
            nxt = int(rng.choice(top, p=p))
            out.append(nxt)
            logits = step(nxt)
    finally:
        model.enc.set_carry(saved)
        model.train(was_training)
    return " ".join(itos[t] for t in out)


def load_torch_awd_lstm(model, lstm_state_dicts, emb_weight, itos,
                        stoi_wt103):
    """Install wt103-pretrained torch AWD-LSTM weights into ``model.enc``
    (a :class:`LanguageModelNet` or :class:`TextClassificationNet`) in
    place, and return the model (Text.py:678-702).

    lstm_state_dicts: {'<i>.lstm.weight_ih_l0': (4H, I), '<i>.lstm.
    weight_hh_l0_raw', '<i>.lstm.bias_ih_l0', '<i>.lstm.bias_hh_l0'} of
    torch tensors or arrays; emb_weight (V_wt103, emb) whose rows are
    remapped through ``itos`` (our id -> token) and ``stoi_wt103``, with
    the mean row for tokens wt103 lacks."""
    enc = model.enc
    with torch.no_grad():
        for i, layer in enumerate(enc.lstms()):
            pre = f"{i}.lstm."
            for name, key, t in (("w_ih", "weight_ih_l0", True),
                                 ("w_hh", "weight_hh_l0_raw", True),
                                 ("b_ih", "bias_ih_l0", False),
                                 ("b_hh", "bias_hh_l0", False)):
                arr = _np(lstm_state_dicts[pre + key])
                getattr(layer, name).copy_(torch.from_numpy(
                    np.ascontiguousarray(arr.T if t else arr,
                                         dtype=np.float32)))
        emb_weight = _np(emb_weight)
        w = np.tile(emb_weight.mean(axis=0), (len(itos), 1)).astype(
            np.float32)
        for i, tok in itos.items():
            if tok in stoi_wt103:
                w[i] = emb_weight[stoi_wt103[tok]]
        enc.word_embed.weight.copy_(torch.from_numpy(w))
    return model
