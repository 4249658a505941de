"""GRU4Rec — session-based RNN recommendation (Hidasi et al., ICLR 2016;
Hidasi & Karatzoglou, CIKM 2018).

Port of ``cornac_tpu/models/gru4rec.py``: stacked GRU cells over padded
fixed-length session batches, the ``seq_utils.batch_loss`` family over
in-batch and shared popularity^alpha negatives (with the logQ correction),
adagrad with momentum (``ops.optim.adagrad_m``), the constrained embedding
(input tied to the output table), embedding and hidden dropout, and
best-on-validation selection through ``epoch_loop`` (checkpoints, resume).

The cell is the JAX package's, not ``nn.GRU``'s: the candidate state is
``tanh(p_h + (r * h) @ U_h)`` (cuDNN computes ``r * (h @ U_h + b)``). Its
three input projections are one matmul over the whole sequence, hoisted out
of the recurrence; each step is then two matmuls (``h @ [U_z | U_r]`` and
``(r * h) @ U_h``), in a Python loop over L. On a padded step the state
carries through unchanged (left-padded inference histories). The input
embedding's rows are gathered through ``gather_rows``, so their gradient
sums in batch order (``accumulate_rows``).

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank
(``seq_utils.fit_sessions``): each rank runs the recurrence over its rows
of a batch, their dropout masks cut from the whole batch's, and
``score_history_batch`` splits the histories over the ranks when their
padded count divides the mesh, as the JAX package shards them.
"""

import numpy as np
import torch

from ..engine.nn import Tree
from ..ops.accumulate import gather_rows
from ..ops.optim import adagrad_m
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


def _init_gru(rng, vocab, layers, embedding, constrained):
    """The JAX package's parameter pytree as a ``Tree``: the stacked
    cells, the output table and bias, and (unconstrained) the input
    embedding, drawn in its order."""

    def xav(shape):
        return xavier_uniform(shape, rng)

    out_dim = layers[-1]
    if constrained:
        emb = None
        in_dim = out_dim
    else:
        e = embedding if embedding else layers[0]
        emb = rng.normal(0, 0.05, (vocab, e)).astype(np.float32)
        in_dim = e

    cells = []
    for h in layers:
        cells.append(Tree(
            W_z=xav((in_dim, h)), U_z=xav((h, h)), b_z=np.zeros(h, np.float32),
            W_r=xav((in_dim, h)), U_r=xav((h, h)), b_r=np.zeros(h, np.float32),
            W_h=xav((in_dim, h)), U_h=xav((h, h)), b_h=np.zeros(h, np.float32),
        ))
        in_dim = h

    params = dict(
        cells=torch.nn.ModuleList(cells),
        out_emb=rng.normal(0, 0.05, (vocab, out_dim)).astype(np.float32),
        out_b=np.zeros(vocab, np.float32),
    )
    if emb is not None:
        params["emb"] = emb
    return Tree(**params)


def _gru_states(params, seq, step_mask=None, drop_masks=None):
    """(B, L, H_last) top-layer states over an item-id sequence (B, L).

    ``step_mask`` (B, L) marks real steps; on a padded step every layer's
    state carries through. ``drop_masks`` (training): {"embed": (B, L, E),
    "hidden": [(B, L, H_i)]} inverted-dropout masks."""
    emb_table = params.emb if hasattr(params, "emb") else params.out_emb
    B, L = seq.shape
    x = gather_rows(emb_table, seq.reshape(-1)).reshape(B, L, emb_table.shape[1])
    if step_mask is None:
        step_mask = torch.ones(seq.shape, dtype=torch.float32, device=seq.device)
    if drop_masks is not None:
        x = x * drop_masks["embed"]

    inputs = x
    for li, cell in enumerate(params.cells):
        H = cell.U_z.shape[0]
        W = torch.cat([cell.W_z, cell.W_r, cell.W_h], dim=1)
        bias = torch.cat([cell.b_z, cell.b_r, cell.b_h])
        U_zr = torch.cat([cell.U_z, cell.U_r], dim=1)
        proj = inputs @ W + bias  # (B, L, 3H), off the recurrence
        m = step_mask[:, :, None]
        h = torch.zeros((B, H), dtype=torch.float32, device=seq.device)
        states = []
        for t in range(L):
            p_t, m_t = proj[:, t], m[:, t]
            rec = h @ U_zr  # z and r recurrent parts together
            z = torch.sigmoid(p_t[:, :H] + rec[:, :H])
            r = torch.sigmoid(p_t[:, H:2 * H] + rec[:, H:])
            h_tilde = torch.tanh(p_t[:, 2 * H:] + (r * h) @ cell.U_h)
            h_new = (1 - z) * h + z * h_tilde
            h = m_t * h_new + (1 - m_t) * h
            states.append(h)
        states = torch.stack(states, dim=1)  # (B, L, H_i)
        if drop_masks is not None:
            states = states * drop_masks["hidden"][li]
        inputs = states
    return inputs


class GRU4Rec(NextItemRecommender):
    """GRU session model trained on padded session batches.

    Parameters mirror the JAX package's (``layers``, ``loss``,
    ``batch_size`` in events, ``dropout_p_embed``, ``dropout_p_hidden``,
    ``learning_rate``, ``momentum``, ``sample_alpha``, ``n_sample``,
    ``embedding``, ``constrained_embedding``, ``n_epochs``, ``bpreg``,
    ``elu_param``, ``logq``, ``model_selection`` with ``val_eval_every``,
    ``val_k``, ``val_metric``, ``max_len``, ``seed``). ``device``: where it
    trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="GRU4Rec",
        layers=None,
        loss="cross-entropy",
        batch_size=512,
        dropout_p_embed=0.0,
        dropout_p_hidden=0.0,
        learning_rate=0.05,
        momentum=0.0,
        sample_alpha=0.5,
        n_sample=2048,
        embedding=0,
        constrained_embedding=True,
        n_epochs=10,
        bpreg=1.0,
        elu_param=0.5,
        logq=0.0,
        device=None,
        model_selection="last",
        val_eval_every=5,
        val_k=20,
        val_metric="recall",
        max_len=50,
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
        self.layers = [100] if layers is None else list(layers)
        self.loss = loss
        self.batch_size = batch_size
        self.dropout_p_embed = dropout_p_embed
        self.dropout_p_hidden = dropout_p_hidden
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.sample_alpha = sample_alpha
        self.n_sample = n_sample
        self.embedding = self.layers[0] if embedding == "layersize" else embedding
        self.constrained_embedding = constrained_embedding
        self.n_epochs = n_epochs
        self.bpreg = bpreg
        self.elu_param = elu_param
        self.logq = logq
        self.device = device
        self.model_selection = model_selection
        self.val_eval_every = val_eval_every
        self.val_k = val_k
        self.val_metric = val_metric
        self.max_len = max_len
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.rng = get_rng(seed)

    def _emb_dim(self):
        if self.constrained_embedding:
            return self.layers[-1]
        return self.embedding if self.embedding else self.layers[0]

    def _drop_masks(self, generator, B, L, device):
        """The batch's dropout masks from ``generator`` (embedding, then
        each layer's), or None when neither rate is set."""
        p_embed, p_hidden = self.dropout_p_embed, self.dropout_p_hidden
        if p_embed <= 0 and p_hidden <= 0:
            return None

        def mask(p, width):
            if p <= 0:
                return torch.ones((B, L, width), dtype=torch.float32, device=device)
            keep = 1.0 - p
            draw = torch.rand((B, L, width), generator=generator, device=device) < keep
            return draw.to(torch.float32) / keep

        return {"embed": mask(p_embed, self._emb_dim()),
                "hidden": [mask(p_hidden, h) for h in self.layers]}

    def loss_fn(self, seq, tgt, m, generator, cum_probs, log_p0=None, share=None):
        """One batch's loss: its dropout masks, then its shared negatives,
        drawn from ``generator``; with a ``share`` (``fit_sessions``), this
        rank's share of it."""
        drop = self._drop_masks(generator, seq.shape[0], seq.shape[1], seq.device)
        negs = sample_negatives(generator, cum_probs, (self.n_sample,))
        return self.loss_on(seq, tgt, m, drop, negs, log_p0, share)

    def loss_on(self, seq, tgt, m, drop, negs, log_p0=None, share=None):
        """One batch's loss on given draws: the dropout masks ``drop`` (or
        None) and the shared negatives ``negs``, all the whole batch's;
        ``share``: the states of this rank's rows only."""
        if share is not None and not share.whole:
            seq_m, m_m = share.take(seq), share.take(m)
            if drop is not None:
                drop = {"embed": share.take(drop["embed"]),
                        "hidden": [share.take(h) for h in drop["hidden"]]}
        else:
            seq_m, m_m = seq, m
        states = _gru_states(self.params, seq_m, step_mask=m_m, drop_masks=drop)
        return batch_loss(self.loss, states, self.params.out_emb, self.params.out_b, tgt, m,
                          negs, logq=self.logq, log_p0=log_p0, sample_alpha=self.sample_alpha,
                          bpreg=self.bpreg, elu_param=self.elu_param, share=share)

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        if not self.trainable:
            return self

        vocab = self.total_items
        dev = self._device()
        if not hasattr(self, "params"):
            self.params = _init_gru(self.rng, vocab, self.layers, self.embedding,
                                    self.constrained_embedding)
        self.params.to(dev)

        users, inputs, targets, mask = build_session_examples(train_set, self.max_len)
        # the recurrence is sequential in L: train at the longest session
        L = max(1, int(mask.sum(axis=1).max()))
        inputs, targets, mask = inputs[:, :L], targets[:, :L], mask[:, :L]
        n = len(users)
        bsz = sessions_per_batch(self.batch_size, mask, n)
        n_pad = (-n) % bsz
        if n_pad:
            inputs = np.concatenate([inputs, np.zeros((n_pad, L), np.int32)])
            targets = np.concatenate([targets, np.zeros((n_pad, L), np.int32)])
            mask = np.concatenate([mask, np.zeros((n_pad, L), np.float32)])

        cum_probs = neg_sampling_table(train_set, self.sample_alpha, vocab, dev)
        log_p0 = None
        if self.logq > 0:
            counts = np.bincount(np.asarray(train_set.uir_tuple[1]),
                                 minlength=vocab).astype(np.float64)
            log_p0 = torch.as_tensor(
                np.log(counts / max(counts.sum(), 1.0) + 1e-24).astype(np.float32), device=dev)

        fit_sessions(self, adagrad_m(self.learning_rate, self.momentum), inputs, targets, mask,
                     bsz, lambda seq, tgt, m, gen, share: self.loss_fn(
                         seq, tgt, m, gen, cum_probs, log_p0, share),
                     train_set, val_set)
        return self

    @torch.no_grad()
    def _history_states(self, histories):
        """The last top-layer state of each left-padded history, (B, H)."""
        padded, lengths = pad_histories(histories, self.max_len)
        step_mask = (np.arange(self.max_len)[None, :]
                     >= (self.max_len - lengths)[:, None]).astype(np.float32)
        (padded, step_mask), B = pad_batch_rows([padded, step_mask])
        dev = self.params.out_emb.device
        seq = torch.as_tensor(padded, dtype=torch.int64, device=dev)
        m = torch.as_tensor(step_mask, device=dev)

        def last_states(seq, m):
            return _gru_states(self.params, seq, m)[:, -1, :]

        return split_scoring(self.mesh, last_states, seq.shape[0], seq, m)[:B]

    def score(self, user_idx, history_items, **kwargs):
        return self.score_history_batch([user_idx], [list(history_items)])[0]

    @torch.no_grad()
    def score_history_batch_device(self, user_indices, histories):
        """(B, num_items) float32 next-item logits on the model's device."""
        h = self._history_states(histories)
        return (h @ self.params.out_emb.T + self.params.out_b)[:, :self.num_items]

    def score_history_batch(self, user_indices, histories):
        scores = self.score_history_batch_device(user_indices, histories)
        return scores.cpu().numpy().astype(np.float64)
