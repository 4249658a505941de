"""TransformerRec and BERT4Rec: transformer next-item models.

Port of ``cornac_tpu/models/transformer_rec.py``: pre-LN transformer blocks
(``engine.nn``, feed-forward 4 d wide, GELU) over padded sessions, the item
embedding shared by input and output (rows ``n_items`` and ``n_items + 1``
are the padding and the mask token), learned positions and output biases.

- backbone 'bert'/'electra': bidirectional attention; 'gpt2': causal;
  'xlnet': bidirectional, with the two-stream pass of the 'plm' objective.
- objective 'mlm': Cloze (masked positions predicted, always the mask
  token); 'clm': the next item at every position (``loss_at='all'``) or at
  the last; 'rtd': ELECTRA with a tied generator (the mlm pass, masked
  positions replaced by draws from its own softmax, a per-position
  original-or-replaced head, ``mlm + rtd_lambda * bce``); 'plm': a random
  factorization order per row, the query stream predicting the targets.
- Losses: ``seq_utils.batch_loss`` over the selected positions (in-batch
  targets at the same step and shared popularity^alpha negatives).

Every draw of a step (the mask uniforms, the negatives, plm's order
uniforms, the dropout masks, rtd's corruption uniforms) comes from the
epoch's generator (``seq_utils.fit_sessions``: keyed on seed and global
epoch), or is handed in (``loss_on``), so one step can be held to the JAX
package's on its own draws. The item embedding's rows are gathered through
``gather_rows``, so their gradient sums in batch order (``accumulate_rows``)
and a seeded fit keeps its bits on the card. Attention is matmul, mask,
softmax, matmul, as the JAX package writes it.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank
(``seq_utils.fit_sessions``), a step's minibatch rounded down to a
multiple of the mesh's size as in the JAX package: every draw is made for
the whole batch (the Cloze masks, plm's orders, the dropout masks, rtd's
corruption), each rank encodes its rows of it and scores them against
every column's target, and ``score_history_batch`` splits the histories
over the ranks when their padded count divides the mesh.
"""

import numpy as np
import torch

from ..engine.nn import (
    Tree,
    block_attention,
    block_ffn,
    init_transformer_block,
    layer_norm,
)
from ..ops.accumulate import gather_rows
from ..ops.optim import adam
from ..parallel.mesh import check_mesh
from ..parallel.sharded import round_batch, split_scoring
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
)

BACKBONES = ("bert", "gpt2", "xlnet", "electra")
OBJECTIVES = ("mlm", "clm", "plm", "rtd")
VALID_LOSS_AT = ("all", "last")
_TINY = float(np.finfo(np.float32).tiny)


def _init_transformer(rng, vocab_with_special, d, n_layers, max_len, ffn_mult=4, rtd=False,
                      plm=False):
    """The JAX package's pytree as a ``Tree``, from ``rng`` in its order:
    the blocks, the embedding, the positions, then rtd's discriminator
    weight or plm's query vector."""

    def xav(shape):
        return xavier_uniform(shape, rng)

    blocks = [init_transformer_block(xav, d, ffn_mult=ffn_mult) for _ in range(n_layers)]
    params = dict(
        emb=rng.normal(0, 0.02, (vocab_with_special, d)).astype(np.float32),
        pos=rng.normal(0, 0.02, (max_len, d)).astype(np.float32),
        blocks=torch.nn.ModuleList(blocks),
        ln_f_g=np.ones(d, np.float32),
        ln_f_b=np.zeros(d, np.float32),
        out_b=np.zeros(vocab_with_special, np.float32),
    )
    if rtd:
        params["disc_w"] = xav((d, 1))
        params["disc_b"] = np.zeros(1, np.float32)
    if plm:
        params["g_query"] = rng.normal(0, 0.02, (1, 1, d)).astype(np.float32)
    return Tree(**params)


def _drop_fn(dropout, masks):
    """``drop(x, i)`` applying the ``i``-th keep mask of ``masks`` (drawn
    beforehand, in call order), or the identity."""
    if dropout <= 0.0 or masks is None:
        return lambda x, i: x
    keep = 1.0 - dropout
    it = iter(masks)
    return lambda x, i: x * next(it) / keep


def _embed(params, seq):
    B, L = seq.shape
    d = params.emb.shape[1]
    return gather_rows(params.emb, seq.reshape(-1)).reshape(B, L, d) + params.pos[None, :, :]


def _encode(params, seq, pad_id, n_heads, causal, dropout=0.0, drop_masks=None):
    """(B, L, d) states of ``seq``: padded positions attend nowhere and are
    zeroed after every block; ``drop_masks`` the keep masks of the dropout
    sites in order (the embedding, then each block's attention and
    feed-forward outputs)."""
    B, L = seq.shape
    key_mask = seq != pad_id
    keep = key_mask[:, :, None]
    drop = _drop_fn(dropout, drop_masks)

    h = _embed(params, seq) * keep
    h = drop(h, 0)
    if causal:
        struct = torch.tril(torch.ones((L, L), dtype=torch.bool, device=seq.device))[None]
    else:
        struct = torch.ones((1, L, L), dtype=torch.bool, device=seq.device)
    attn_mask = struct & key_mask[:, None, :]

    for bi, blk in enumerate(params.blocks):
        q = layer_norm(h, blk.ln1_g, blk.ln1_b)
        h = h + block_attention(blk, q, q, attn_mask, n_heads, drop, 2 * bi + 1)
        h = h + block_ffn(blk, h, drop, 2 * bi + 2)
        h = h * keep
    return layer_norm(h, params.ln_f_g, params.ln_f_b)


def _encode_two_stream(params, seq, pad_id, n_heads, perm_mask, target_mask, dropout=0.0,
                       drop_masks=None):
    """XLNet's two-stream pass: ``perm_mask`` (B, L, L) bool, True where
    query q may attend key k; the content stream also sees itself, the
    query stream never does. Returns the query stream's final states (rows
    meaningful at ``target_mask``'s positions). Dropout sites in order: the
    embedding, then per block the content and query attention outputs and
    the content and query feed-forward outputs."""
    L = seq.shape[1]
    key_mask = seq != pad_id
    keep = key_mask[:, :, None]
    drop = _drop_fn(dropout, drop_masks)

    h = _embed(params, seq) * keep
    h = drop(h, 0)
    g = params.g_query.expand(h.shape) + params.pos[None, :, :]

    eye = torch.eye(L, dtype=torch.bool, device=seq.device)[None]
    content_mask = (perm_mask | eye) & key_mask[:, None, :]
    query_mask = perm_mask & key_mask[:, None, :]

    for bi, blk in enumerate(params.blocks):
        hq = layer_norm(h, blk.ln1_g, blk.ln1_b)
        gq = layer_norm(g, blk.ln1_g, blk.ln1_b)
        h_new = h + block_attention(blk, hq, hq, content_mask, n_heads, drop, 4 * bi + 1)
        g_new = g + block_attention(blk, gq, hq, query_mask, n_heads, drop, 4 * bi + 2)
        h = h_new + block_ffn(blk, h_new, drop, 4 * bi + 3)
        g = g_new + block_ffn(blk, g_new, drop, 4 * bi + 4)
        h = h * keep
        g = g * keep
    return layer_norm(g, params.ln_f_g, params.ln_f_b)


def _bernoulli_mask(u, valid, p):
    """Masked positions from the uniforms ``u`` (B, L) with the reference's
    safeguards: at least one masked in a row with a valid position (its
    highest-u valid one), and where a row has two valid positions or more,
    at least one visible (its lowest-u valid one unmasked)."""
    L = valid.shape[1]
    cols = torch.arange(L, device=valid.device)[None, :]
    masked = (u < p) & valid
    none_masked = ~torch.any(masked, dim=1)
    fallback = torch.argmax(torch.where(valid, u, -1.0), dim=1)
    masked = masked | (none_masked[:, None] & (cols == fallback[:, None]) & valid)
    n_valid = torch.sum(valid, dim=1)
    all_masked = torch.sum(masked, dim=1) >= torch.clamp(n_valid, min=1)
    keep = torch.argmin(torch.where(valid, u, 2.0), dim=1)
    unmask = all_masked[:, None] & (cols == keep[:, None]) & (n_valid > 1)[:, None]
    return masked & ~unmask


def _perm_allowed(is_target, order_u):
    """plm's attention mask from the order uniforms: rank the positions of
    each row by ``order_u`` (``argsort(argsort(u))``), pin non-targets to
    -1; query q may attend key k unless k is a target at or after q in the
    order."""
    rank = torch.argsort(torch.argsort(order_u, dim=1), dim=1)
    perm_index = torch.where(is_target, rank, -1)
    perm_mask = (perm_index[:, :, None] <= perm_index[:, None, :]) & is_target[:, None, :]
    return ~perm_mask


def _encode_scores(params, seq, pad_id, n_heads, causal, n_items):
    """Next-item logits (B, n_items) from the last position's state."""
    last = _encode(params, seq, pad_id, n_heads, causal)[:, -1, :]
    return last @ params.emb[:n_items].T + params.out_b[:n_items]


class TransformerRec(NextItemRecommender):
    """Configurable transformer next-item model.

    Parameters mirror the JAX package's: ``backbone`` (bert, gpt2, xlnet,
    electra), ``objective`` (mlm, clm, plm, rtd; clm switches the backbone
    to gpt2, mlm/plm/rtd refuse gpt2), ``loss_at`` ('all' or 'last', clm),
    ``loss`` (the ``seq_utils`` family), ``batch_size`` (sessions a step),
    ``n_sample``, ``sample_alpha``, ``num_blocks``, ``num_heads``,
    ``dropout``, ``l2_reg``, ``bpreg``, ``elu_param``, ``mask_prob``,
    ``rtd_lambda``, ``model_selection`` ('last' or 'best') with
    ``val_eval_every``, ``val_k``, ``val_metric``; ``n_layers`` and
    ``n_heads`` alias ``num_blocks`` and ``num_heads``. ``device``: where it
    trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="TransformerRec",
        backbone="bert",
        objective="mlm",
        loss_at="all",
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
        mask_prob=0.2,
        rtd_lambda=1.0,
        device=None,
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
        if backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}")
        if objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}")
        if loss_at not in VALID_LOSS_AT:
            raise ValueError(f"loss_at must be one of {VALID_LOSS_AT}")
        if loss not in SUPPORTED_LOSSES:
            raise ValueError(f"loss='{loss}' not supported; choose from {SUPPORTED_LOSSES}")
        if model_selection not in ("last", "best"):
            raise ValueError(
                f"model_selection='{model_selection}' not supported; choose 'last' or 'best'"
            )
        if objective == "clm" and backbone != "gpt2":
            backbone = "gpt2"  # the causal objective needs causal attention
        if objective in ("mlm", "plm", "rtd") and backbone == "gpt2":
            raise ValueError(f"objective '{objective}' needs a bidirectional backbone")

        self.backbone = backbone
        self.objective = objective
        self.loss_at = loss_at
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
        self.mask_prob = mask_prob
        self.rtd_lambda = rtd_lambda
        self.device = device
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

    # ------------------------------------------------------------ draws
    def _n_drop_sites(self):
        per_block = 4 if self.objective == "plm" else 2
        return 1 + per_block * self.num_blocks

    def draws(self, generator, B, L, device, cum_probs):
        """One step's draws from ``generator``, in this order: the mask
        uniforms (mlm, rtd, plm), the shared negatives, plm's order
        uniforms, the dropout keep masks of the first pass, then rtd's
        corruption uniforms (B, L, n_items) and its second pass's masks."""
        d = self.embedding_dim
        keep = 1.0 - float(self.dropout)

        def drop_masks():
            if self.dropout <= 0.0:
                return None
            return [torch.rand((B, L, d), generator=generator, device=device) < keep
                    for _ in range(self._n_drop_sites())]

        out = {}
        if self.objective != "clm":
            out["mask_u"] = torch.rand((B, L), generator=generator, device=device)
        out["negs"] = sample_negatives(generator, cum_probs, (self.n_sample,))
        if self.objective == "plm":
            out["order_u"] = torch.rand((B, L), generator=generator, device=device)
        out["drop"] = drop_masks()
        if self.objective == "rtd":
            out["corrupt_u"] = torch.rand((B, L, self.num_items), generator=generator,
                                          device=device)
            out["drop_disc"] = drop_masks()
        return out

    # ------------------------------------------------------------- loss
    def _position_loss(self, states, labels, sel, negs, share=None):
        params = self.params
        return batch_loss(self.loss, states, params.emb, params.out_b, labels,
                          sel.to(torch.float32), negs, bpreg=self.bpreg,
                          elu_param=self.elu_param, share=share)

    def loss_on(self, seq, tgt, m, draws, share=None):
        """One batch's loss on given draws (``draws``' keys as it makes
        them; rtd may carry ``"sampled"``, the corrupting items, in place of
        ``"corrupt_u"``). ``share`` (``parallel.sharded.Share``): the batch
        and the draws stay whole, and this rank encodes its rows of them,
        its share of the loss."""
        params = self.params
        pad_id, n_heads = self.num_items, self.num_heads
        dropout = float(self.dropout)
        valid = (m > 0) & (seq != pad_id)
        objective = self.objective
        mine = (lambda x: x) if share is None else share.take

        def masks(key):
            drawn = draws.get(key)
            return None if drawn is None else [mine(x) for x in drawn]

        if objective == "clm":
            states = _encode(params, mine(seq), pad_id, n_heads, True, dropout, masks("drop"))
            loss = self._position_loss(states, tgt, m > 0, draws["negs"], share)
        elif objective in ("mlm", "rtd"):
            is_masked = _bernoulli_mask(draws["mask_u"], valid, self.mask_prob)
            model_in = torch.where(is_masked, self.num_items + 1, seq)
            states = _encode(params, mine(model_in), pad_id, n_heads, False, dropout,
                             masks("drop"))
            loss = self._position_loss(states, seq, is_masked, draws["negs"], share)
            if objective == "rtd":
                sampled = draws.get("sampled")
                if sampled is None:
                    # a draw from the generator's own softmax: Gumbel-max on
                    # the (B, L, n_items) logits, built once and noised in place
                    vocab = self.num_items
                    with torch.no_grad():
                        logits = states @ params.emb[:vocab].T + params.out_b[:vocab]
                        gumbel = mine(draws["corrupt_u"]).clamp(min=_TINY).log().neg_().log_(
                        ).neg_()
                        sampled = torch.argmax(logits.add_(gumbel), dim=-1)
                        del logits, gumbel
                else:
                    sampled = mine(sampled)
                corrupted = torch.where(mine(is_masked), sampled, mine(seq))
                disc_states = _encode(params, corrupted, pad_id, n_heads, False, dropout,
                                      masks("drop_disc"))
                disc_logits = (disc_states @ params.disc_w).squeeze(-1) + params.disc_b
                disc_labels = (corrupted != mine(seq)).to(torch.float32)
                bce = (torch.clamp(disc_logits, min=0) - disc_logits * disc_labels
                       + torch.log1p(torch.exp(-torch.abs(disc_logits))))
                vf = valid.to(torch.float32)
                count = torch.clamp(torch.sum(vf), min=1.0)  # the whole batch's
                disc_loss = torch.sum(bce * mine(vf)) / count
                loss = loss + self.rtd_lambda * disc_loss
        else:  # plm
            is_target = _bernoulli_mask(draws["mask_u"], valid, self.mask_prob)
            allowed = _perm_allowed(is_target, draws["order_u"])
            g = _encode_two_stream(params, mine(seq), pad_id, n_heads, mine(allowed),
                                   mine(is_target), dropout, masks("drop"))
            loss = self._position_loss(g, seq, is_target, draws["negs"], share)
        if self.l2_reg > 0 and (share is None or share.first):
            loss = loss + self.l2_reg * (torch.sum(params.emb ** 2) + torch.sum(params.pos ** 2))
        return loss

    # -------------------------------------------------------------- fit
    def training_rows(self, train_set):
        """The padded training rows (inputs, targets, mask) and the rows a
        step holds: full sessions for the Cloze objectives, shifted pairs
        for clm (only the last transition with ``loss_at='last'``), padded
        to whole batches."""
        pad_id, L = self.num_items, self.max_len
        _, inputs, targets, mask = build_session_examples(train_set, L)
        if self.objective in ("mlm", "plm", "rtd"):
            # each row's full session, its most recent max_len items
            lengths = mask.sum(axis=1).astype(np.int64) + 1
            full = np.concatenate([inputs[:, :1], targets], axis=1)
            shift = (lengths > L).astype(np.int64)
            cols = np.arange(L)[None, :]
            kept = np.minimum(lengths, L)[:, None]
            src = np.take_along_axis(full, cols + shift[:, None], axis=1)
            inputs = np.where(cols < kept, src, pad_id).astype(inputs.dtype)
            mask = (cols < kept).astype(np.float32)
        else:
            inputs = np.where(mask > 0, inputs, pad_id).astype(inputs.dtype)
            if self.loss_at == "last":
                rows = np.arange(mask.shape[0])
                last_pos = np.maximum(mask.sum(axis=1).astype(int) - 1, 0)
                only_last = np.zeros_like(mask)
                only_last[rows, last_pos] = mask[rows, last_pos]
                mask = only_last
        n = inputs.shape[0]
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_pad = (-n) % bsz
        if n_pad:
            inputs = np.concatenate([inputs, np.full((n_pad, L), pad_id, np.int32)])
            targets = np.concatenate([targets, np.zeros((n_pad, L), np.int32)])
            mask = np.concatenate([mask, np.zeros((n_pad, L), np.float32)])
        return inputs, targets, mask, bsz

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        if not self.trainable:
            return self
        vocab = self.num_items
        self.pad_id, self.mask_id = vocab, vocab + 1
        dev = self._device()
        if not hasattr(self, "params"):
            self.params = _init_transformer(
                self.rng, vocab + 2, self.embedding_dim, self.num_blocks, self.max_len,
                rtd=self.objective == "rtd", plm=self.objective == "plm")
        self.params.to(dev)
        inputs, targets, mask, bsz = self.training_rows(train_set)
        cum_probs = neg_sampling_table(train_set, self.sample_alpha, vocab, dev)

        def loss_fn(seq, tgt, m, gen, share):
            return self.loss_on(seq, tgt, m, self.draws(gen, *seq.shape, dev, cum_probs), share)

        fit_sessions(self, adam(self.learning_rate), inputs, targets, mask, bsz, loss_fn,
                     train_set, val_set)
        return self

    # ---------------------------------------------------------- scoring
    def score(self, user_idx, history_items, **kwargs):
        return self.score_history_batch([user_idx], [list(history_items)])[0]

    def score_history_batch(self, user_indices, histories):
        scores = self.score_history_batch_device(user_indices, histories)
        return scores.cpu().numpy().astype(np.float64)

    @torch.no_grad()
    def score_history_batch_device(self, user_indices, histories):
        """(B, num_items) float32 next-item logits on the model's device:
        the mask token appended for mlm, plm and rtd, the last position for
        clm."""
        pad_id = self.num_items
        if self.objective in ("mlm", "plm", "rtd"):
            # the mask token appended: its state scores the next item
            histories = [list(h) + [pad_id + 1] for h in histories]
        padded, _ = pad_histories(histories, self.max_len, pad_value=pad_id)
        (padded,), B = pad_batch_rows([padded])
        seq = torch.as_tensor(padded, dtype=torch.int64, device=self.params.emb.device)

        def scores(rows):
            return _encode_scores(self.params, rows, pad_id, self.num_heads,
                                  self.backbone == "gpt2", self.num_items)

        return split_scoring(self.mesh, scores, seq.shape[0], seq)[:B]


class BERT4Rec(TransformerRec):
    """BERT4Rec (Sun et al., CIKM 2019): the bert backbone with the mlm
    objective."""

    def __init__(
        self,
        name="BERT4Rec",
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
        mask_prob=0.2,
        device=None,
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
        super().__init__(
            name=name, backbone="bert", objective="mlm", embedding_dim=embedding_dim,
            loss=loss, batch_size=batch_size, learning_rate=learning_rate, n_sample=n_sample,
            sample_alpha=sample_alpha, n_epochs=n_epochs, max_len=max_len,
            num_blocks=num_blocks, num_heads=num_heads, dropout=dropout, l2_reg=l2_reg,
            bpreg=bpreg, elu_param=elu_param, mask_prob=mask_prob, device=device,
            model_selection=model_selection, val_eval_every=val_eval_every, val_k=val_k,
            val_metric=val_metric, n_layers=n_layers, n_heads=n_heads, trainable=trainable,
            verbose=verbose, seed=seed, mesh=mesh,
        )
