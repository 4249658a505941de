"""TIGER: Recommender Systems with Generative Retrieval (Rajput et al.,
NeurIPS 2023).

Port of ``cornac_tpu/models/tiger.py``: (1) an RQ-VAE (or residual k-means)
turns each item's content features into a hierarchical semantic ID, plus a
last level that tells apart items whose codes collide; (2) a T5-style
encoder-decoder (pre-LN blocks, learned absolute positions, head
projections ``num_heads * d_kv`` wide, one offset token table) generates the
next item's semantic ID from the history's tokens; items are scored by a
beam search over the prefix trie or by the exact likelihood of every item.

Host work stays on the host, as in the JAX package: k-means (k-means++
seeding, Lloyd iterations) and the RQ-VAE's dead-code restarts in numpy
from the model's ``RandomState`` (the same bytes from the same state), the
semantic-ID tables, the trie masks and the beam pruning. The RQ-VAE and the
seq2seq train on the model's device with AdamW (``ops.optim.adamw``, the
seq2seq's learning rate constant or optax's warmup-cosine schedule); each
epoch's permutation comes from a generator keyed on (seed, epoch). Every
differentiated lookup (a codebook row, a token embedding) goes through
``gather_rows``, so its gradient sums in batch order (``accumulate_rows``)
and a seeded fit keeps its bits on the card. ``used`` (the codes an RQ-VAE
epoch chose) is read once an epoch, after the epoch, for the restarts.

``mesh`` (``parallel.make_mesh``) trains the seq2seq data-parallel over
every rank, its minibatch rounded down to a multiple of the mesh's size as
in the JAX package: each rank encodes and decodes its rows of a minibatch,
takes their cross entropy over the whole minibatch's size
(``vaecf.batch_mean``), and ``ops.optim.step`` sums the gradients. The
tokenizers (the RQ-VAE or residual k-means) stay single-program, each
rank fitting the same one, and the beam pruning stays on the host.
"""

from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.nn import Dense, Tree
from ..ops.accumulate import gather_rows
from ..ops.optim import adamw, step, warmup_cosine_decay_schedule
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch
from ..utils import get_rng
from ..utils.init_utils import xavier_uniform
from .recommender import NextItemRecommender
from .vaecf import batch_mean

SUPPORTED_SCORING = ("beam", "exact")
SUPPORTED_TOKENIZERS = ("rqvae", "rkmeans")
SUPPORTED_LR_SCHEDULES = ("constant", "cosine")
_DIST_ROWS = 64  # rows of a chunk of the host's (rows, k, dim) distance blocks


# --------------------------------------------------------------- tokenizers
def _nearest(x, c):
    """``((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)``, a chunk of
    rows at a time: the same arithmetic element for element, so the same
    bytes, without the whole (n, k, dim) block in memory."""
    ids = np.empty(x.shape[0], np.int64)
    for s in range(0, x.shape[0], _DIST_ROWS):
        ids[s:s + _DIST_ROWS] = ((x[s:s + _DIST_ROWS, None, :] - c[None]) ** 2).sum(-1).argmin(1)
    return ids


def _kmeans_np(x, k, rng, n_iters=10):
    """k-means++ seeding and Lloyd iterations (host numpy)."""
    n = x.shape[0]
    if n < k:
        idx = rng.randint(0, n, size=k)
        return x[idx] + 1e-4 * rng.randn(k, x.shape[1]).astype(x.dtype)
    centroids = np.empty((k, x.shape[1]), x.dtype)
    centroids[0] = x[rng.randint(n)]
    d2 = ((x - centroids[0]) ** 2).sum(1)
    for i in range(1, k):
        p = d2 + 1e-12
        centroids[i] = x[rng.choice(n, p=p / p.sum())]
        d2 = np.minimum(d2, ((x - centroids[i]) ** 2).sum(1))
    for _ in range(n_iters):
        ids = _nearest(x, centroids)
        for c in range(k):
            m = ids == c
            if m.any():
                centroids[c] = x[m].mean(0)
            else:
                centroids[c] = x[rng.randint(n)]
    return centroids


def _restart_dead_codes(r, codebooks, dead, rng):
    """The RQ-VAE's dead-code restart on the host, level by level: the
    ``dead`` codes ((levels, k) bool) of a level become random residuals of
    that level (``r`` quantized by the levels before), ``codebooks`` updated
    in place."""
    for level, cb in enumerate(codebooks):
        if dead[level].any():
            idx = rng.randint(0, len(r), size=int(dead[level].sum()))
            cb[dead[level]] = r[idx]
        r = r - cb[_nearest(r, cb)]


def _mlp_params(rng, sizes):
    return torch.nn.ModuleList(
        Dense(xavier_uniform((sizes[i], sizes[i + 1]), rng), np.zeros(sizes[i + 1], np.float32))
        for i in range(len(sizes) - 1))


def _mlp_apply(layers, x):
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _rq_quantize(codebooks, z, beta):
    """Residual quantization with the VQ losses: (ids (B, levels), the
    quantized sum, the codebook and commitment losses). The codebook rows
    are gathered through ``gather_rows``; the residual passed on is cut from
    the graph, as the JAX package's ``stop_gradient`` cuts it."""
    ids, q = [], torch.zeros_like(z)
    loss = 0.0
    r = z
    for level in range(codebooks.shape[0]):
        cb = codebooks[level]
        d = torch.sum(r**2, dim=1, keepdim=True) - 2 * r @ cb.T + torch.sum(cb**2, dim=1)[None]
        lid = torch.argmin(d, dim=1)
        e = gather_rows(cb, lid)
        loss = loss + torch.mean((e - r.detach()) ** 2) + beta * torch.mean((r - e.detach()) ** 2)
        ids.append(lid)
        q = q + e
        r = r - e.detach()
    return torch.stack(ids, dim=1), q, loss


def _rqvae_loss(params, x, beta):
    z = _mlp_apply(params.enc, x)
    ids, q, loss_rq = _rq_quantize(params.codebooks, z, beta)
    z_q = z + (q - z).detach()  # the straight-through estimator
    x_hat = _mlp_apply(params.dec, z_q)
    return torch.mean((x_hat - x) ** 2) + loss_rq, ids


# ------------------------------------------------------------- seq2seq
def _init_blocks(rng, d, n_layers, ffn, cross, n_heads, d_kv):
    """T5-style blocks: head projections (d, n_heads * d_kv), decoupled
    from d; the draws in the JAX package's order."""
    a = n_heads * d_kv

    def xav(shape):
        return xavier_uniform(shape, rng)

    blocks = []
    for _ in range(n_layers):
        blk = dict(Wq=xav((d, a)), Wk=xav((d, a)), Wv=xav((d, a)), Wo=xav((a, d)),
                   ln1_g=np.ones(d, np.float32), ln1_b=np.zeros(d, np.float32),
                   ff1=xav((d, ffn)), ff1_b=np.zeros(ffn, np.float32),
                   ff2=xav((ffn, d)), ff2_b=np.zeros(d, np.float32),
                   ln2_g=np.ones(d, np.float32), ln2_b=np.zeros(d, np.float32))
        if cross:
            blk.update(Cq=xav((d, a)), Ck=xav((d, a)), Cv=xav((d, a)), Co=xav((a, d)),
                       lnc_g=np.ones(d, np.float32), lnc_b=np.zeros(d, np.float32))
        blocks.append(Tree(**blk))
    return torch.nn.ModuleList(blocks)


def _ln(x, g, b):
    """TIGER's layer norm: eps 1e-6 over the biased variance, divided by
    the root (``engine.nn.layer_norm``'s eps is 1e-8)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


def _mha(q_in, kv_in, Wq, Wk, Wv, Wo, mask, n_heads):
    B, Lq, _ = q_in.shape
    Lk = kv_in.shape[1]
    hd = Wq.shape[1] // n_heads
    Q = (q_in @ Wq).reshape(B, Lq, n_heads, hd)
    K = (kv_in @ Wk).reshape(B, Lk, n_heads, hd)
    V = (kv_in @ Wv).reshape(B, Lk, n_heads, hd)
    logits = torch.einsum("blhd,bmhd->bhlm", Q, K) / float(np.sqrt(hd))
    logits = torch.where(mask[:, None, :, :], logits, -1e9)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", attn, V).reshape(B, Lq, n_heads * hd) @ Wo


def _ffn(blk, h):
    f = _ln(h, blk.ln2_g, blk.ln2_b)
    return torch.relu(f @ blk.ff1 + blk.ff1_b) @ blk.ff2 + blk.ff2_b


def _embed_tokens(params, tokens):
    shape = tokens.shape
    return gather_rows(params.tok_emb, tokens.reshape(-1)).reshape(*shape,
                                                                   params.tok_emb.shape[1])


def _encoder(params, tokens, n_heads):
    """tokens (B, S) offset ids, 0 the padding: (encoder output, key mask)."""
    S = tokens.shape[1]
    key_mask = tokens != 0
    keep = key_mask[:, :, None]
    h = _embed_tokens(params, tokens) + params.enc_pos[None, :S]
    h = h * keep
    mask = key_mask[:, None, :].expand(-1, S, -1)
    for blk in params.enc_blocks:
        q = _ln(h, blk.ln1_g, blk.ln1_b)
        h = h + _mha(q, q, blk.Wq, blk.Wk, blk.Wv, blk.Wo, mask, n_heads)
        h = h + _ffn(blk, h)
        h = h * keep
    return _ln(h, params.enc_lnf_g, params.enc_lnf_b), key_mask


def _decoder(params, dec_emb, enc_out, enc_mask, n_heads):
    """dec_emb (B, t, d): BOS and the target prefix's embeddings. Returns
    the hidden states (B, t, d): causal self-attention, then attention over
    the encoder's unpadded positions."""
    t = dec_emb.shape[1]
    h = dec_emb + params.dec_pos[None, :t]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=h.device))[None]
    cross = enc_mask[:, None, :].expand(-1, t, -1)
    for blk in params.dec_blocks:
        q = _ln(h, blk.ln1_g, blk.ln1_b)
        h = h + _mha(q, q, blk.Wq, blk.Wk, blk.Wv, blk.Wo, causal, n_heads)
        c = _ln(h, blk.lnc_g, blk.lnc_b)
        h = h + _mha(c, enc_out, blk.Cq, blk.Ck, blk.Cv, blk.Co, cross, n_heads)
        h = h + _ffn(blk, h)
    return _ln(h, params.dec_lnf_g, params.dec_lnf_b)


def _dec_emb(params, offsets, prefix):
    """BOS and the embedded (un-offset) ``prefix`` tokens (R, level)."""
    R, level = prefix.shape
    bos = params.bos.expand(R, 1, params.bos.shape[-1])
    if level == 0:
        return bos
    return torch.cat([bos, _embed_tokens(params, prefix + offsets[None, :level])], dim=1)


def _seq2seq_loss(params, offsets, enc_tokens, target, n_heads, denom=None):
    """The per-level cross entropy of the target semantic IDs, summed over
    the levels, each the batch mean; on a mesh the rows are a rank's share
    of a minibatch of ``denom`` rows (``vaecf.batch_mean``)."""
    enc_out, enc_mask = _encoder(params, enc_tokens, n_heads)
    h = _decoder(params, _dec_emb(params, offsets, target[:, :-1]), enc_out, enc_mask, n_heads)
    loss = 0.0
    for level, head in enumerate(params.heads):
        logits = h[:, level] @ head
        loss = loss + batch_mean(F.cross_entropy(logits, target[:, level], reduction="none"),
                                 denom)
    return loss


def _beam_level_logp(params, offsets, prefix, enc_out, enc_mask, n_heads, level):
    """(R, level_size) next-token log-probs of R (history, beam prefix)
    rows: one decoder call a level."""
    h = _decoder(params, _dec_emb(params, offsets, prefix), enc_out, enc_mask, n_heads)
    return torch.log_softmax(h[:, -1] @ params.heads[level], dim=-1)


def _exact_cross_scores(params, offsets, targets, enc_out, enc_mask, n_heads):
    """(B, nb) sequence log-probs of nb target IDs for B encoded histories:
    the (history, target) cross product in one decoder batch."""
    B = enc_out.shape[0]
    nb, L = targets.shape
    dec = _dec_emb(params, offsets, targets[:, :-1])
    d = dec.shape[-1]
    dec_t = dec[None].expand(B, nb, L, d).reshape(B * nb, L, d)
    eo = torch.repeat_interleave(enc_out, nb, dim=0)
    em = torch.repeat_interleave(enc_mask, nb, dim=0)
    h = _decoder(params, dec_t, eo, em, n_heads)
    tgt = targets[None].expand(B, nb, L).reshape(B * nb, L)
    scores = torch.zeros((B * nb,), dtype=h.dtype, device=h.device)
    for level, head in enumerate(params.heads):
        logp = torch.log_softmax(h[:, level] @ head, dim=-1)
        scores = scores + torch.take_along_dim(logp, tgt[:, level:level + 1], dim=1)[:, 0]
    return scores.reshape(B, nb)


def _used_codes(ids, levels, k):
    """(levels, k) bool: the codes that an epoch's batches chose (``ids``,
    a list of (B, levels) tensors), on their device."""
    used = torch.zeros((levels, k), dtype=torch.bool, device=ids[0].device)
    for lid in ids:
        used.scatter_(1, lid.T, True)
    return used


def _epoch_perm(seed, epoch, n_total, n, device):
    """An epoch's row order: a permutation of the padded count, each row
    index taken modulo the true count, as the JAX package pads an epoch."""
    from ..utils.checkpoint import epoch_generator

    gen = epoch_generator(seed, epoch, device)
    return torch.randperm(n_total, generator=gen, device=device) % n


def _train_epoch(params, opt, opt_state, batch_loss, perm, bsz, mesh=None):
    """One epoch of ``opt`` steps over ``perm``'s batches of ``bsz`` rows:
    ``batch_loss(idx)`` gives a batch's loss (and optionally an auxiliary
    output, collected). Returns (state, loss sum, the auxiliaries). With
    ``mesh`` the loss is a rank's share of the batch's, the gradients and
    the loss sum summed over every rank."""
    named = dict(params.named_parameters())
    loss_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    aux = []
    for b in range(perm.shape[0] // bsz):
        out = batch_loss(perm[b * bsz:(b + 1) * bsz])
        loss, extra = out if isinstance(out, tuple) else (out, None)
        opt_state = step(named, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
        aux.append(extra)
    if mesh is not None:
        all_sum(mesh, loss_sum, None)
    return opt_state, loss_sum, aux


class TIGER(NextItemRecommender):
    """Generative retrieval over hierarchical semantic IDs.

    Parameters mirror the JAX package's: the tokenizer (``tokenizer``
    'rqvae' or 'rkmeans', ``feature_standardize``, ``rqvae_latent_dim``,
    ``rqvae_hidden_dims``, ``rqvae_num_levels``, ``rqvae_codebook_size``,
    ``rqvae_beta``, ``rqvae_n_epochs``, ``rqvae_learning_rate``,
    ``rqvae_batch_size``, ``rqvae_weight_decay``), the seq2seq (``d_model``,
    ``d_ff``, ``num_heads``, ``d_kv``, ``num_enc_layers``,
    ``num_dec_layers``, ``max_len``, ``n_epochs``, ``learning_rate``,
    ``weight_decay``, ``batch_size``, ``lr_schedule`` 'constant' or 'cosine'
    with ``warmup_steps``), best-on-validation selection (``model_selection``,
    ``val_metric``, ``val_eval_every``, ``val_k``, ``val_sample``) and
    scoring (``scoring`` 'beam' or 'exact', ``n_beams``,
    ``scoring_batch_size``). ``dropout`` is accepted and unused, as in the
    JAX package: no layer reads it. ``device``: where it trains and scores
    (default ``None`` or ``"auto"``: the card, raising without one;
    ``"cpu"`` asks for the CPU). The item features come from the train
    set's ``item_feature`` (``NextItemEvaluation(..., item_feature=...)``).
    """

    def __init__(
        self,
        name="TIGER",
        tokenizer="rqvae",
        feature_standardize=False,
        rqvae_latent_dim=32,
        rqvae_hidden_dims=(512, 256, 128),
        rqvae_num_levels=3,
        rqvae_codebook_size=256,
        rqvae_beta=0.25,
        rqvae_n_epochs=200,
        rqvae_learning_rate=0.001,
        rqvae_batch_size=1024,
        rqvae_weight_decay=0.0,
        d_model=128,
        d_ff=1024,
        num_heads=6,
        d_kv=64,
        num_enc_layers=4,
        num_dec_layers=4,
        dropout=0.1,
        max_len=20,
        n_epochs=20,
        learning_rate=0.001,
        weight_decay=0.0001,
        batch_size=256,
        lr_schedule="constant",
        warmup_steps=10000,
        model_selection="last",
        val_metric="ndcg",
        val_eval_every=5,
        val_k=10,
        val_sample=2000,
        scoring="beam",
        n_beams=20,
        scoring_batch_size=2048,
        device=None,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
    ):
        super().__init__(name, trainable=trainable, verbose=verbose)
        if scoring not in SUPPORTED_SCORING:
            raise ValueError("scoring='%s' not supported; choose from %s"
                             % (scoring, SUPPORTED_SCORING))
        if tokenizer not in SUPPORTED_TOKENIZERS:
            raise ValueError("tokenizer='%s' not supported; choose from %s"
                             % (tokenizer, SUPPORTED_TOKENIZERS))
        if lr_schedule not in SUPPORTED_LR_SCHEDULES:
            raise ValueError("lr_schedule='%s' not supported; choose from %s"
                             % (lr_schedule, SUPPORTED_LR_SCHEDULES))
        if model_selection not in ("last", "best"):
            raise ValueError("model_selection must be 'last' or 'best'")
        self.tokenizer = tokenizer
        self.feature_standardize = feature_standardize
        self.rqvae_latent_dim = rqvae_latent_dim
        self.rqvae_hidden_dims = tuple(rqvae_hidden_dims)
        self.rqvae_num_levels = rqvae_num_levels
        self.rqvae_codebook_size = rqvae_codebook_size
        self.rqvae_beta = rqvae_beta
        self.rqvae_n_epochs = rqvae_n_epochs
        self.rqvae_learning_rate = rqvae_learning_rate
        self.rqvae_batch_size = rqvae_batch_size
        self.rqvae_weight_decay = rqvae_weight_decay
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_heads = num_heads
        self.d_kv = d_kv
        self.num_enc_layers = num_enc_layers
        self.num_dec_layers = num_dec_layers
        self.dropout = dropout
        self.max_len = max_len
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.lr_schedule = lr_schedule
        self.warmup_steps = warmup_steps
        self.model_selection = model_selection
        self.val_metric = val_metric
        self.val_eval_every = val_eval_every
        self.val_k = val_k
        self.val_sample = val_sample
        self.scoring = scoring
        self.n_beams = n_beams
        self.scoring_batch_size = scoring_batch_size
        self.device = None if device == "auto" else device
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.rng = get_rng(seed)

    # ------------------------------------------------------- features
    def _get_item_features(self):
        item_feature = getattr(self.train_set, "item_feature", None)
        features = getattr(item_feature, "features", None)
        if features is None:
            raise ValueError(
                "TIGER requires precomputed item content embeddings. Provide them via "
                "NextItemEvaluation.from_splits(..., item_feature=FeatureModality("
                "features=..., ids=...)).")
        if features.shape[0] < self.total_items:
            raise ValueError(
                "item_feature has %d rows but %d items are known; every item needs a feature "
                "vector." % (features.shape[0], self.total_items))
        return np.asarray(features[: self.total_items], dtype="float32")

    # ------------------------------------------------------ tokenizer
    def _init_rqvae(self, n_features):
        """The encoder, decoder and a codebook draw from ``self.rng``, in
        the JAX package's order (the codebooks are replaced by k-means)."""
        L, K, D = self.rqvae_num_levels, self.rqvae_codebook_size, self.rqvae_latent_dim
        sizes = [n_features, *self.rqvae_hidden_dims, D]
        rng = self.rng
        return Tree(enc=_mlp_params(rng, sizes), dec=_mlp_params(rng, sizes[::-1]),
                    codebooks=(rng.randn(L, K, D).astype(np.float32) * 0.01))

    def _kmeans_codebooks(self, z):
        """Codebooks from k-means on the encoder's residuals ``z`` (host
        numpy), level by level."""
        cbs, r = [], z
        for _ in range(self.rqvae_num_levels):
            c = _kmeans_np(r, self.rqvae_codebook_size, self.rng)
            cbs.append(c)
            r = r - c[_nearest(r, c)]
        return np.stack(cbs).astype(np.float32)

    def _fit_rqvae(self, feats):
        dev = self._device()
        params = self._init_rqvae(feats.shape[1]).to(dev)
        feats_d = torch.as_tensor(feats, device=dev)
        with torch.no_grad():
            z = _mlp_apply(params.enc, feats_d).cpu().numpy()
            params.codebooks.copy_(torch.as_tensor(self._kmeans_codebooks(z)))

        L, K = self.rqvae_num_levels, self.rqvae_codebook_size
        opt = adamw(self.rqvae_learning_rate, weight_decay=self.rqvae_weight_decay)
        named = dict(params.named_parameters())
        opt_state = opt.init(named)
        n = feats.shape[0]
        bsz = min(self.rqvae_batch_size, n)
        n_total = n + ((-n) % bsz)
        beta = self.rqvae_beta
        seed = self.rng.randint(2**31)
        self.rqvae_restarts = 0
        for e in range(self.rqvae_n_epochs):
            perm = _epoch_perm(seed, e, n_total, n, dev)
            opt_state, loss, ids = _train_epoch(
                params, opt, opt_state, lambda idx: _rqvae_loss(params, feats_d[idx], beta),
                perm, bsz)
            # dead-code restart on the host: unused codes become random
            # residuals, and the optimizer's moments start again
            used_np = _used_codes(ids, L, K).cpu().numpy()
            if not used_np.all():
                with torch.no_grad():
                    z = _mlp_apply(params.enc, feats_d).cpu().numpy()
                cbs = params.codebooks.detach().cpu().numpy().copy()
                _restart_dead_codes(z, cbs, ~used_np, self.rng)
                with torch.no_grad():
                    params.codebooks.copy_(torch.as_tensor(cbs))
                opt_state = opt.init(named)
                self.rqvae_restarts += int((~used_np).sum())
            if self.verbose:
                print("RQ-VAE epoch %d/%d loss %.4f"
                      % (e + 1, self.rqvae_n_epochs, float(loss) / (n_total // bsz)))
        self.rqvae_params = params
        with torch.no_grad():
            z = _mlp_apply(params.enc, feats_d)
            ids, _, _ = _rq_quantize(params.codebooks, z, beta)
        return ids.cpu().numpy().astype(np.int64)

    def _fit_rkmeans(self, feats):
        self.rkmeans_centroids = []
        codes = []
        r = feats.copy()
        for _ in range(self.rqvae_num_levels):
            c = _kmeans_np(r, self.rqvae_codebook_size, self.rng)
            ids = _nearest(r, c)
            r = r - c[ids]
            self.rkmeans_centroids.append(c)
            codes.append(ids)
        return np.stack(codes, axis=1).astype(np.int64)

    def _build_semantic_ids(self, codes):
        counters = defaultdict(int)
        dedup = np.zeros(len(codes), dtype=np.int64)
        for i, row in enumerate(map(tuple, codes)):
            dedup[i] = counters[row]
            counters[row] += 1
        self.sid_table = np.concatenate([codes, dedup[:, None]], axis=1)
        self.level_sizes = [self.rqvae_codebook_size] * self.rqvae_num_levels + [
            int(dedup.max()) + 1]
        children = [defaultdict(set) for _ in self.level_sizes]
        self.sid_to_item = {}
        for i, row in enumerate(self.sid_table):
            sid = tuple(int(v) for v in row)
            for level in range(len(sid)):
                children[level][sid[:level]].add(sid[level])
            self.sid_to_item[sid] = i
        self.prefix_children = [
            {p: np.fromiter(sorted(t), dtype=np.int64) for p, t in lc.items()}
            for lc in children
        ]

    # -------------------------------------------------------- seq2seq
    def _init_seq2seq(self):
        rng = self.rng
        d = self.d_model
        n_levels = len(self.level_sizes)
        vocab = 1 + sum(self.level_sizes)
        S = self.max_len * n_levels
        self.offsets = np.concatenate(([1], 1 + np.cumsum(self.level_sizes[:-1]))).astype(np.int64)
        self.pad_idx = self.total_items
        self.enc_token_table = np.zeros((self.total_items + 1, n_levels), dtype=np.int64)
        self.enc_token_table[: self.total_items] = self.sid_table + self.offsets
        tok_emb = rng.normal(0, 0.02, (vocab, d)).astype(np.float32)
        tok_emb[0] = 0.0
        enc_pos = rng.normal(0, 0.02, (S, d)).astype(np.float32)
        dec_pos = rng.normal(0, 0.02, (n_levels + 1, d)).astype(np.float32)
        bos = rng.normal(0, 0.02, (1, 1, d)).astype(np.float32)
        enc_blocks = _init_blocks(rng, d, self.num_enc_layers, self.d_ff, False, self.num_heads,
                                  self.d_kv)
        dec_blocks = _init_blocks(rng, d, self.num_dec_layers, self.d_ff, True, self.num_heads,
                                  self.d_kv)
        heads = [xavier_uniform((d, s), rng) for s in self.level_sizes]
        return Tree(tok_emb=tok_emb, enc_pos=enc_pos, dec_pos=dec_pos, bos=bos,
                    enc_blocks=enc_blocks, dec_blocks=dec_blocks,
                    enc_lnf_g=np.ones(d, np.float32), enc_lnf_b=np.zeros(d, np.float32),
                    dec_lnf_g=np.ones(d, np.float32), dec_lnf_b=np.zeros(d, np.float32),
                    heads=heads)

    def _build_examples(self, train_set):
        item_arr = train_set.uir_tuple[1]
        hists, outs = [], []
        for sid, idx_list in train_set.sessions.items():
            items = [int(item_arr[i]) for i in idx_list]
            for t in range(1, len(items)):
                h = items[:t][-self.max_len:]
                hists.append([self.pad_idx] * (self.max_len - len(h)) + h)
                outs.append(items[t])
        if not hists:
            raise ValueError("No session with at least 2 items to train on.")
        return np.asarray(hists, np.int64), np.asarray(outs, np.int64)

    def _optimizer(self, total_steps):
        if self.lr_schedule == "cosine":
            lr = warmup_cosine_decay_schedule(0.0, self.learning_rate,
                                              min(self.warmup_steps, total_steps), total_steps)
        else:
            lr = self.learning_rate
        return adamw(lr, weight_decay=self.weight_decay)

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        if not self.trainable:
            return self
        from ..utils.checkpoint import epoch_loop

        dev = self._device()
        feats = self._get_item_features()
        if self.feature_standardize:
            mean, std = feats.mean(0), feats.std(0)
            std[std == 0] = 1.0
            feats = ((feats - mean) / std).astype("float32")
        codes = self._fit_rkmeans(feats) if self.tokenizer == "rkmeans" else self._fit_rqvae(feats)
        self._build_semantic_ids(codes)
        self.params = self._init_seq2seq().to(dev)

        hists, outs = self._build_examples(train_set)
        enc_d = torch.as_tensor(self.enc_token_table[hists].reshape(len(hists), -1), device=dev)
        tgt_d = torch.as_tensor(self.sid_table[outs], device=dev)
        offsets_d = torch.as_tensor(self.offsets, device=dev)
        n = len(hists)
        mesh = self.mesh
        bsz = round_batch(mesh, min(self.batch_size, n))
        n_total = n + ((-n) % bsz)
        n_batches = n_total // bsz
        share = Share(mesh, bsz)
        opt = self._optimizer(max(1, n_batches * self.n_epochs))
        params = self.params
        named = dict(params.named_parameters())
        n_heads = self.num_heads
        seed = self.rng.randint(2**31)
        select_best = self.model_selection == "best" and val_set is not None

        def batch_loss(idx):
            idx = share.take(idx)
            return _seq2seq_loss(params, offsets_d, enc_d[idx], tgt_d[idx], n_heads,
                                 None if mesh is None else bsz)

        def run_chunk(state, start, e):
            opt_state = state["opt"]
            for epoch in range(start, start + e):
                perm = _epoch_perm(seed, epoch, n_total, n, dev)
                opt_state, loss, _ = _train_epoch(params, opt, opt_state, batch_loss, perm, bsz,
                                                  mesh)
                if self.verbose:
                    print("TIGER epoch %d/%d loss %.4f"
                          % (epoch + 1, self.n_epochs, float(loss) / n_batches))
                if select_best and (epoch + 1) % self.val_eval_every == 0:
                    score = self._validate(val_set)
                    if score > state["best_score"]:
                        with torch.no_grad():
                            for name, p in named.items():
                                state["best"][name].copy_(p)
                        state["best_score"] = float(score)
            return dict(state, opt=opt_state), {"loss": loss}

        state = {"opt": opt.init(named),
                 "best": {name: p.detach().clone() for name, p in named.items()},
                 "best_score": -np.inf}
        state = epoch_loop(self, self.n_epochs, run_chunk, state, resident=named)
        if select_best and np.isfinite(state["best_score"]):
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(state["best"][name])
        return self

    # ------------------------------------------------------ validation
    def _validate(self, val_set):
        from ..metrics import AUC, MRR, NDCG, Recall

        name = self.val_metric.lower()
        metric = {
            "recall": lambda: Recall(k=self.val_k),
            "ndcg": lambda: NDCG(k=self.val_k),
            "auc": AUC,
            "mrr": MRR,
        }.get(name)
        if metric is None:
            raise ValueError("val_metric='%s' not supported" % self.val_metric)
        metric = metric()

        item_arr = val_set.uir_tuple[1]
        sessions = []
        for sid, idx_list in val_set.sessions.items():
            items = [int(item_arr[i]) for i in idx_list]
            if len(items) >= 2:
                sessions.append(items)
        if self.val_sample is not None and len(sessions) > self.val_sample:
            idx = self.rng.choice(len(sessions), size=self.val_sample, replace=False)
            sessions = [sessions[i] for i in sorted(idx)]

        num_items = self.train_set.num_items
        item_indices = np.arange(num_items)
        orig_beams, self.n_beams = self.n_beams, max(self.n_beams, self.val_k)
        results = []
        sessions = [it for it in sessions if it[-1] < num_items]
        chunk = 128
        for start in range(0, len(sessions), chunk):
            batch = sessions[start: start + chunk]
            rows = self.score_history_batch([None] * len(batch),
                                            [it[:-1] for it in batch])[:, :num_items]
            for scores, items in zip(rows, batch):
                target = items[-1]
                results.append(metric.compute(
                    gt_pos=np.array([target]), gt_neg=np.delete(item_indices, target),
                    pd_rank=np.argsort(-scores), pd_scores=scores, item_indices=item_indices))
        self.n_beams = orig_beams
        return float(np.mean(results)) if results else 0.0

    # --------------------------------------------------------- scoring
    def _encode_history_batch(self, histories):
        hists = []
        for h in histories:
            h = list(h)[-self.max_len:]
            hists.append([self.pad_idx] * (self.max_len - len(h)) + h)
        tokens = self.enc_token_table[np.asarray(hists, np.int64)].reshape(len(hists), -1)
        return _encoder(self.params, torch.as_tensor(tokens, device=self.params.tok_emb.device),
                        self.num_heads)

    def score(self, user_idx, history_items, **kwargs):
        if len(history_items) == 0:
            return np.ones(self.total_items, dtype="float")
        return self.score_history_batch([user_idx], [list(history_items)])[0]

    @torch.no_grad()
    def score_history_batch(self, user_indices, histories):
        empty = [b for b, h in enumerate(histories) if len(h) == 0]
        safe = [list(h) if len(h) else [0] for h in histories]
        enc_out, enc_mask = self._encode_history_batch(safe)
        if self.scoring == "beam":
            out = self._score_beam_batch(enc_out, enc_mask)
        else:
            out = self._score_exact_batch(enc_out, enc_mask)
        for b in empty:
            out[b] = 1.0
        return out

    def _score_beam_batch(self, enc_out, enc_mask):
        """A beam search over the semantic-ID trie per history: each level
        one decoder call over every (history, beam) row on the device; the
        trie masks and the pruning on the host (``argpartition``, then
        ``argsort`` of the kept totals, as the JAX package orders them)."""
        B = int(enc_out.shape[0])
        dev = enc_out.device
        offsets_d = torch.as_tensor(self.offsets, device=dev)
        beams = [[()] for _ in range(B)]
        beam_lp = [np.zeros(1) for _ in range(B)]
        for level, size in enumerate(self.level_sizes):
            counts = [len(bs) for bs in beams]
            R = max(counts)
            prefix = np.zeros((B, R, level), np.int64)
            for b, bs in enumerate(beams):
                for r in range(R):
                    prefix[b, r, :] = bs[min(r, counts[b] - 1)]
            eo = torch.repeat_interleave(enc_out, R, dim=0)
            em = torch.repeat_interleave(enc_mask, R, dim=0)
            logp = _beam_level_logp(
                self.params, offsets_d, torch.as_tensor(prefix.reshape(B * R, level), device=dev),
                eo, em, self.num_heads, level).cpu().numpy().reshape(B, R, size)
            new_beams, new_lp = [], []
            for b in range(B):
                allowed = np.full((counts[b], size), -np.inf)
                for i, beam in enumerate(beams[b]):
                    allowed[i, self.prefix_children[level][beam]] = 0.0
                total = (beam_lp[b][:, None] + logp[b, : counts[b]] + allowed).ravel()
                k = min(self.n_beams, int(np.isfinite(total).sum()))
                top = np.argpartition(-total, k - 1)[:k]
                top = top[np.argsort(-total[top])]
                new_beams.append([beams[b][j // size] + (int(j % size),) for j in top])
                new_lp.append(total[top])
            beams, beam_lp = new_beams, new_lp
        out = np.full((B, self.total_items), -1e10, dtype="float")
        for b in range(B):
            for sid, lp in zip(beams[b], beam_lp[b]):
                out[b, self.sid_to_item[sid]] = lp
        return out

    def _score_exact_batch(self, enc_out, enc_mask):
        """(B, total_items) exact sequence log-probs, in chunks of 32
        histories by 512 targets."""
        N = len(self.sid_table)
        B = int(enc_out.shape[0])
        dev = enc_out.device
        offsets_d = torch.as_tensor(self.offsets, device=dev)
        tc = min(512, N)
        uc = min(32, B)
        sid = self.sid_table
        pad_n = (-N) % tc
        if pad_n:
            sid = np.concatenate([sid, np.repeat(sid[-1:], pad_n, axis=0)])
        pad_b = (-B) % uc
        if pad_b:
            enc_out = torch.cat([enc_out, enc_out[-1:].expand(pad_b, -1, -1)])
            enc_mask = torch.cat([enc_mask, enc_mask[-1:].expand(pad_b, -1)])
        sid_d = torch.as_tensor(sid, device=dev)
        scores = np.empty((B + pad_b, N + pad_n), dtype="float")
        for us in range(0, B + pad_b, uc):
            eo, em = enc_out[us: us + uc], enc_mask[us: us + uc]
            for ts in range(0, N + pad_n, tc):
                scores[us: us + uc, ts: ts + tc] = _exact_cross_scores(
                    self.params, offsets_d, sid_d[ts: ts + tc], eo, em, self.num_heads
                ).cpu().numpy()
        out = np.full((B, self.total_items), -1e10, dtype="float")
        out[:, :N] = scores[:B, :N]
        return out
