"""SASRec — Self-Attentive Sequential Recommendation (Kang & McAuley,
ICDM 2018).

Port of ``cornac_tpu/models/sasrec.py``: causal transformer blocks
(``engine.nn``) over left-padded fixed-length sessions, the input and output
item embedding shared (one extra row, index ``num_items``, is the padding
id), optional learned positions and output biases, the
``seq_utils.batch_loss`` family over in-batch and popularity^alpha sampled
negatives, Adam with betas (0.9, 0.98) (``ops.optim.adam``), L2 on the
embeddings, and best-on-validation selection through ``epoch_loop``
(checkpoints, resume).

The states are the JAX package's: embeddings times sqrt(d), plus positions,
padded positions zeroed; each block layer-norms only the queries (keys and
values come from the raw residual stream, the original implementation's
quirk), adds attention and a ReLU feed-forward, and zeroes padded positions
again; a final layer norm. Attention is matmul, mask, softmax, matmul, as
the JAX package writes it. The embedding's rows are gathered through
``gather_rows``, so their gradient sums in batch order
(``accumulate_rows``).

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank
(``seq_utils.fit_sessions``): each rank computes the states of its rows of
a batch, its dropout masks cut from the whole batch's, and
``score_history_batch`` splits the histories over the ranks when their
padded count divides the mesh, as the JAX package shards them.
"""

import numpy as np
import torch

from ..engine.nn import (
    ACTIVATIONS,
    Tree,
    block_attention,
    block_ffn,
    init_transformer_block,
    layer_norm,
    make_drop,
)
from ..ops.accumulate import gather_rows
from ..ops.optim import adam
from ..parallel.mesh import check_mesh
from ..parallel.sharded import split_scoring
from ..utils import get_rng
from ..utils.init_utils import xavier_uniform
from .recommender import NextItemRecommender
from .seq_utils import (
    SUPPORTED_LOSSES,
    batch_loss,
    build_session_examples,
    fit_sessions,
    neg_sampling_table,
    pad_batch_rows,
    pad_histories,
    sample_negatives,
    sessions_per_batch,
)


def _init_sasrec(rng, vocab, d, n_layers, max_len, use_pos_emb, use_biases):
    """The JAX package's pytree as a ``Tree``: the blocks first, then the
    embedding (vocab + 1 rows) and the positions, from ``rng`` in its
    order."""

    def xav(shape):
        return xavier_uniform(shape, rng)

    blocks = [init_transformer_block(xav, d, ffn_mult=1) for _ in range(n_layers)]
    params = dict(
        emb=rng.normal(0, 0.02, (vocab + 1, d)).astype(np.float32),
        blocks=torch.nn.ModuleList(blocks),
        ln_f_g=np.ones(d, np.float32),
        ln_f_b=np.zeros(d, np.float32),
    )
    if use_pos_emb:
        params["pos"] = rng.normal(0, 0.02, (max_len, d)).astype(np.float32)
    if use_biases:
        params["out_b"] = np.zeros(vocab + 1, np.float32)
    return Tree(**params)


def _sasrec_states(params, seq, pad_id, n_heads, dropout=0.0, generator=None, share=None):
    """(B, L, d) causal-transformer states of ``seq`` (B, L); padded
    positions attend nowhere and are zeroed. ``dropout`` with a
    ``generator`` (training) drops the embedded input and each block's
    attention and feed-forward outputs, in that order; ``share``: ``seq``
    is a rank's rows of a batch, the masks drawn for the whole batch."""
    B, L = seq.shape
    d = params.emb.shape[1]
    key_mask = seq != pad_id  # (B, L)
    keep = key_mask[:, :, None]

    h = gather_rows(params.emb, seq.reshape(-1)).reshape(B, L, d) * float(np.sqrt(d))
    if hasattr(params, "pos"):
        h = h + params.pos[None, :, :]
    h = h * keep

    drop = make_drop(dropout, generator, share)
    h = drop(h, 0)

    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=seq.device))
    attn_mask = causal[None, :, :] & key_mask[:, None, :]  # (B, L, L)

    for bi, blk in enumerate(params.blocks):
        # queries layer-normed, keys and values from the raw residual
        q = layer_norm(h, blk.ln1_g, blk.ln1_b)
        h = h + block_attention(blk, q, h, attn_mask, n_heads, drop, 2 * bi + 1)
        h = h + block_ffn(blk, h, drop, 2 * bi + 2, act=ACTIVATIONS["relu"])
        h = h * keep

    return layer_norm(h, params.ln_f_g, params.ln_f_b)


def _sasrec_scores(params, seq, pad_id, n_heads, n_items):
    """Next-item logits (B, n_items) of left-padded histories."""
    last = _sasrec_states(params, seq, pad_id, n_heads)[:, -1, :]
    logits = last @ params.emb[:n_items].T
    if hasattr(params, "out_b"):
        logits = logits + params.out_b[:n_items][None, :]
    return logits


class SASRec(NextItemRecommender):
    """Causal-attention next-item model on padded session batches.

    Parameters mirror the JAX package's (``embedding_dim``, ``loss``,
    ``batch_size`` in events, ``learning_rate``, ``n_sample``,
    ``sample_alpha``, ``n_epochs``, ``max_len``, ``num_blocks``,
    ``num_heads``, ``dropout``, ``l2_reg``, ``bpreg``, ``elu_param``,
    ``use_pos_emb``, ``use_biases``, ``model_selection`` with
    ``val_eval_every``, ``val_k``, ``val_metric``; ``n_layers`` and
    ``n_heads`` alias ``num_blocks`` and ``num_heads``). ``device``: where it
    trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="SASRec",
        embedding_dim=100,
        loss="ce",
        batch_size=512,
        learning_rate=0.001,
        n_sample=2048,
        sample_alpha=0.5,
        n_epochs=10,
        max_len=50,
        num_blocks=2,
        num_heads=1,
        dropout=0.2,
        l2_reg=0.0,
        bpreg=1.0,
        elu_param=0.5,
        device=None,
        use_pos_emb=True,
        use_biases=False,
        model_selection="last",
        val_eval_every=5,
        val_k=20,
        val_metric="recall",
        n_layers=None,
        n_heads=None,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if loss not in SUPPORTED_LOSSES:
            raise ValueError(f"loss='{loss}' not supported; choose from {SUPPORTED_LOSSES}")
        if model_selection not in ("last", "best"):
            raise ValueError(
                f"model_selection='{model_selection}' not supported; choose 'last' or 'best'"
            )
        self.embedding_dim = embedding_dim
        self.loss = loss
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.n_sample = n_sample
        self.sample_alpha = sample_alpha
        self.n_epochs = n_epochs
        self.max_len = max_len
        self.num_blocks = num_blocks if n_layers is None else n_layers
        self.num_heads = num_heads if n_heads is None else n_heads
        self.dropout = dropout
        self.l2_reg = l2_reg
        self.bpreg = bpreg
        self.elu_param = elu_param
        self.device = device
        self.use_pos_emb = use_pos_emb
        self.use_biases = use_biases
        self.model_selection = model_selection
        self.val_eval_every = val_eval_every
        self.val_k = val_k
        self.val_metric = val_metric
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.rng = get_rng(seed)
        assert embedding_dim % self.num_heads == 0

    def loss_fn(self, seq, tgt, m, generator, cum_probs, share=None):
        """One batch's loss: its dropout masks, then its shared negatives,
        drawn from ``generator``; with a ``share`` (``fit_sessions``), this
        rank's share of it."""
        params = self.params
        states = _sasrec_states(params, seq if share is None else share.take(seq),
                                self.num_items, self.num_heads, dropout=float(self.dropout),
                                generator=generator, share=share)
        negs = sample_negatives(generator, cum_probs, (self.n_sample,))
        loss = batch_loss(self.loss, states, params.emb, getattr(params, "out_b", None), tgt,
                          m, negs, bpreg=self.bpreg, elu_param=self.elu_param, share=share)
        if self.l2_reg > 0 and (share is None or share.first):
            tables = [params.emb] + ([params.pos] if hasattr(params, "pos") else [])
            loss = loss + self.l2_reg * sum(torch.sum(p**2) for p in tables)
        return loss

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        if not self.trainable:
            return self

        vocab = self.num_items
        pad_id = vocab
        dev = self._device()
        if not hasattr(self, "params"):
            self.params = _init_sasrec(self.rng, vocab, self.embedding_dim, self.num_blocks,
                                       self.max_len, self.use_pos_emb, self.use_biases)
        self.params.to(dev)

        users, inputs, targets, mask = build_session_examples(train_set, self.max_len)
        # left-pad (the layout inference sees)
        lengths = mask.sum(axis=1).astype(int)
        L = self.max_len
        li = np.full_like(inputs, pad_id)
        lt = np.zeros_like(targets)
        lm = np.zeros_like(mask)
        for b, ln in enumerate(lengths):
            if ln > 0:
                li[b, L - ln:] = inputs[b, :ln]
                lt[b, L - ln:] = targets[b, :ln]
                lm[b, L - ln:] = 1.0
        inputs, targets, mask = li, lt, lm

        n = inputs.shape[0]
        bsz = sessions_per_batch(self.batch_size, mask, n)
        n_pad = (-n) % bsz
        if n_pad:
            inputs = np.concatenate([inputs, np.full((n_pad, L), pad_id, np.int32)])
            targets = np.concatenate([targets, np.zeros((n_pad, L), np.int32)])
            mask = np.concatenate([mask, np.zeros((n_pad, L), np.float32)])

        cum_probs = neg_sampling_table(train_set, self.sample_alpha, vocab, dev)
        fit_sessions(self, adam(self.learning_rate, b1=0.9, b2=0.98), inputs, targets, mask,
                     bsz, lambda seq, tgt, m, gen, share: self.loss_fn(seq, tgt, m, gen, cum_probs,
                                                                       share),
                     train_set, val_set)
        return self

    def score(self, user_idx, history_items, **kwargs):
        return self.score_history_batch([user_idx], [list(history_items)])[0]

    @torch.no_grad()
    def score_history_batch_device(self, user_indices, histories):
        """(B, num_items) float32 next-item logits on the model's device."""
        pad_id = self.num_items
        padded, _ = pad_histories(histories, self.max_len, pad_value=pad_id)
        (padded,), B = pad_batch_rows([padded])
        seq = torch.as_tensor(padded, dtype=torch.int64, device=self.params.emb.device)

        def scores(rows):
            return _sasrec_scores(self.params, rows, pad_id, self.num_heads, self.num_items)

        return split_scoring(self.mesh, scores, seq.shape[0], seq)[:B]

    def score_history_batch(self, user_indices, histories):
        scores = self.score_history_batch_device(user_indices, histories)
        return scores.cpu().numpy().astype(np.float64)
