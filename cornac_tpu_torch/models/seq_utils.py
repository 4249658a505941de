"""Shared utilities of the sequential (next-item) models.

Port of ``cornac_tpu/models/seq_utils.py``: padded fixed-length session
batches with masks (``build_session_examples``, ``pad_histories``,
``sessions_per_batch``, ``pad_batch_rows``), the ranking losses (``xe_loss``,
``bpr_max_loss``, ``top1_loss``, ``sampled_xe_logq`` and the family
``batch_loss`` over in-batch and shared sampled negatives), popularity^alpha
negative sampling and best-on-validation scoring. ``adagrad_m`` lives with
the other optimizer rules in ``ops/optim.py`` and is re-exported here.

The losses are the JAX package's formulas in PyTorch on the inputs'
device. ``batch_loss`` gathers the output table's rows through
``ops.accumulate.gather_rows``, so their gradient is summed in batch order
by ``accumulate_rows`` (autograd's own backward of a gather is atomic on
the card). Negatives come from a ``torch.Generator`` the caller keys on
(seed, global epoch), where the JAX package folds the same indices into its
key: the same distribution, another stream.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.accumulate import gather_rows
from ..ops.optim import adagrad_m  # noqa: F401  (the JAX package's home of it)

SUPPORTED_LOSSES = (
    "cross-entropy",
    "xe_softmax",
    "softmax",
    "bpr",
    "bpr-max",
    "top1",
    "bce",
    "ce",
)


def sessions_per_batch(batch_size, mask, n_rows):
    """Rows (sessions) a batch holds so that it carries about
    ``batch_size`` events, as the reference's session-parallel iterator
    does: ``batch_size / mean session length``, at least 1, at most
    ``n_rows``."""
    avg_len = float(np.asarray(mask).sum()) / max(n_rows, 1)
    return int(min(max(1, round(batch_size / max(avg_len, 1.0))), n_rows))


def build_session_examples(train_set, max_len):
    """Every session of at least two items as (user, inputs, targets,
    mask) rows: inputs = session[:-1], targets = session[1:], right-padded
    with 0 to ``max_len``; a longer session keeps its most recent
    ``max_len + 1`` items. Returns numpy arrays (n,), (n, max_len) int32,
    (n, max_len) int32 and (n, max_len) float32."""
    users_arr = train_set.uir_tuple[0]
    item_arr = train_set.uir_tuple[1]

    users, inputs, targets, lengths = [], [], [], []
    for sid, idx_list in train_set.sessions.items():
        items = [int(item_arr[i]) for i in idx_list]
        if len(items) < 2:
            continue
        items = items[-(max_len + 1):]
        users.append(int(users_arr[idx_list[0]]))
        seq_in = items[:-1]
        seq_out = items[1:]
        lengths.append(len(seq_in))
        pad = max_len - len(seq_in)
        inputs.append(seq_in + [0] * pad)
        targets.append(seq_out + [0] * pad)

    if not users:
        raise ValueError("No session with at least 2 items to train on.")

    users = np.asarray(users, dtype=np.int32)
    inputs = np.asarray(inputs, dtype=np.int32)
    targets = np.asarray(targets, dtype=np.int32)
    mask = np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]
    return users, inputs, targets, mask.astype(np.float32)


def pad_histories(histories, max_len, pad_value=0):
    """The last ``max_len`` items of each history, left-padded with
    ``pad_value`` (the most recent item in the last column): (B, max_len)
    int32 and the (B,) lengths."""
    B = len(histories)
    out = np.full((B, max_len), pad_value, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for b, h in enumerate(histories):
        h = list(h)[-max_len:]
        if h:
            out[b, -len(h):] = h
        lengths[b] = len(h)
    return out, lengths


def pad_batch_rows(arrs, multiple=64):
    """Each array's leading (batch) dimension padded to a multiple of
    ``multiple`` by repeating its last row; returns (arrays, original B).
    Bounds the number of batch shapes the scorers see."""
    B = arrs[0].shape[0]
    pad = (-B) % multiple
    if pad == 0:
        return arrs, B
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrs], B


# ---------------------------------------------------------------------- #
# losses
# ---------------------------------------------------------------------- #
def xe_loss(logits, targets, mask):
    """Masked full-softmax cross-entropy (the reference's 'xe')."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, targets[..., None].long(), dim=-1).squeeze(-1)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def bpr_max_loss(pos_scores, neg_scores, neg_mask, bpreg=1.0):
    """BPR-max over sampled negatives (Hidasi & Karatzoglou, CIKM 2018);
    pos_scores (...,), neg_scores and neg_mask (..., n_neg)."""
    w = torch.softmax(torch.where(neg_mask > 0, neg_scores, -torch.inf), dim=-1)
    diff = torch.sigmoid(pos_scores[..., None] - neg_scores)
    core = -torch.log(torch.sum(w * diff * neg_mask, dim=-1) + 1e-24)
    reg = bpreg * torch.sum(w * neg_scores**2 * neg_mask, dim=-1)
    return core + reg


def top1_loss(pos_scores, neg_scores, neg_mask):
    """TOP1 loss (Hidasi et al., ICLR 2016)."""
    diff = torch.sigmoid(neg_scores - pos_scores[..., None])
    reg = torch.sigmoid(neg_scores**2)
    per_neg = (diff + reg) * neg_mask
    return torch.sum(per_neg, dim=-1) / torch.clamp(torch.sum(neg_mask, dim=-1), min=1.0)


def sampled_xe_logq(pos_scores, neg_scores, neg_counts, total_count, neg_mask):
    """Sampled softmax cross-entropy with the logQ correction: the log of
    each negative's sampling probability is taken off its logit."""
    logq = torch.log(neg_counts / total_count + 1e-24)
    corrected = torch.where(neg_mask > 0, neg_scores - logq, -torch.inf)
    all_scores = torch.cat([pos_scores[..., None], corrected], dim=-1)
    return -torch.log_softmax(all_scores, dim=-1)[..., 0]


def neg_sampling_table(train_set, sample_alpha, total_items, device):
    """The cumulative popularity^alpha distribution of the shared
    negatives (alpha = 0: uniform over seen items), float32 on ``device``;
    summed in float64 on the host as the JAX package does."""
    counts = np.bincount(np.asarray(train_set.uir_tuple[1]),
                         minlength=total_items).astype(np.float64)
    w = counts**sample_alpha
    w[counts == 0] = 0.0
    total = w.sum()
    if total <= 0:
        w = np.ones(total_items)
        total = w.sum()
    return torch.as_tensor(np.cumsum(w / total).astype(np.float32), device=device)


def sample_negatives(generator, cum_probs, shape):
    """Inverse-CDF draw of negative item ids (int64) on the table's
    device, uniforms from ``generator``."""
    u = torch.rand(shape, generator=generator, device=cum_probs.device)
    idx = torch.searchsorted(cum_probs, u)
    return torch.clamp(idx, 0, cum_probs.shape[0] - 1)


def batch_loss(
    loss_kind,
    states,
    out_emb,
    out_bias,
    targets,
    mask,
    neg_ids,
    logq=0.0,
    log_p0=None,
    sample_alpha=0.5,
    bpreg=1.0,
    elu_param=0.5,
):
    """The reference's loss family over a padded session batch.

    For every valid (row, step) the score row is [in-batch negatives at the
    same step | shared sampled negatives], the positive on the diagonal of
    the first block; one draw of negatives serves all L steps. states
    (B, L, H); targets, mask (B, L); neg_ids (N,). Returns the mean loss
    over valid positions (a 0-d tensor)."""
    B, L, H = states.shape
    targets = targets.long()
    neg_ids = neg_ids.long()
    flat_t = targets.reshape(-1)
    tgt_emb = gather_rows(out_emb, flat_t).reshape(B, L, H)
    neg_emb = gather_rows(out_emb, neg_ids)
    # in-batch block: scores[b, t, c] = states[b, t] . out_emb[targets[c, t]]
    sc_in = torch.einsum("bth,cth->btc", states, tgt_emb)
    sc_neg = torch.einsum("bth,nh->btn", states, neg_emb)

    def by_col(q):  # (1, L, B) view of a per-(column, step) quantity q[c, t]
        return q.transpose(0, 1)[None, :, :]

    tgt_bias = None
    if out_bias is not None:
        tgt_bias = gather_rows(out_bias, flat_t).reshape(B, L)
        sc_in = sc_in + by_col(tgt_bias)
        sc_neg = sc_neg + gather_rows(out_bias, neg_ids)[None, None, :]

    use_logq = logq > 0.0 and log_p0 is not None
    if use_logq:
        # in-batch negatives are popularity-distributed, sampled ones
        # follow pop**alpha
        lp_t = log_p0[targets]
        sc_in = sc_in - logq * by_col(lp_t)
        sc_neg = sc_neg - logq * sample_alpha * log_p0[neg_ids][None, None, :]

    col_valid = by_col(mask).expand(sc_in.shape)
    pos = torch.einsum("bth,bth->bt", states, tgt_emb)
    if tgt_bias is not None:
        pos = pos + tgt_bias
    if use_logq:
        pos = pos - logq * lp_t

    neg_inf = -1e30
    if loss_kind in ("cross-entropy", "xe_softmax", "softmax", "ce"):
        # every sampled column is valid: only the in-batch block is masked
        masked = torch.cat([torch.where(col_valid > 0, sc_in, neg_inf), sc_neg], dim=-1)
        per_pos = torch.logsumexp(masked, dim=-1) - pos
        return torch.sum(per_pos * mask) / torch.clamp(torch.sum(mask), min=1.0)

    scores = torch.cat([sc_in, sc_neg], dim=-1)  # (B, L, B + N)
    valid = torch.cat([col_valid, torch.ones_like(sc_neg)], dim=-1)
    diag = torch.cat(
        [torch.eye(B, dtype=torch.bool, device=states.device),
         torch.zeros((B, sc_neg.shape[-1]), dtype=torch.bool, device=states.device)], dim=-1,
    )[:, None, :].expand(scores.shape)
    if loss_kind == "bpr":
        off = valid * (~diag)
        lg = F.logsigmoid(pos[..., None] - scores) * off
        per_pos = -torch.sum(lg, dim=-1) / torch.clamp(torch.sum(off, dim=-1), min=1.0)
    elif loss_kind == "bpr-max":
        s = scores
        if elu_param > 0:
            s = F.elu(s, elu_param)
        off = valid * (~diag)
        w = torch.softmax(torch.where((valid > 0) & (~diag), s, neg_inf), dim=-1)
        sig = torch.sigmoid(pos[..., None] - s)
        core = -torch.log(torch.sum(w * sig * off, dim=-1) + 1e-24)
        reg = bpreg * torch.sum(w * s**2 * off, dim=-1)
        per_pos = core + reg
    elif loss_kind == "top1":
        term = (torch.sigmoid(scores - pos[..., None]) + torch.sigmoid(scores**2)) * valid
        denom = torch.clamp(torch.sum(valid, dim=-1), min=1.0)
        per_pos = torch.sum(term, dim=-1) / denom - torch.sigmoid(pos**2) / denom
    elif loss_kind == "bce":
        logits = torch.where(valid > 0, scores, neg_inf)
        labels = diag.to(scores.dtype)
        per_col = (torch.clamp(logits, min=0) - logits * labels
                   + torch.log1p(torch.exp(-torch.abs(logits)))) * valid
        per_pos = torch.sum(per_col, dim=-1) / torch.clamp(torch.sum(valid, dim=-1), min=1.0)
    else:
        raise ValueError(f"unknown loss {loss_kind!r}")

    return torch.sum(per_pos * mask) / torch.clamp(torch.sum(mask), min=1.0)


def val_score(model, train_set, val_set, metric="recall", k=20):
    """The next-item validation metric of best-on-validation selection
    (mode 'last'), or None without a validation set."""
    if val_set is None:
        return None

    from ..eval_methods.next_item_evaluation import ranking_eval
    from ..metrics import AUC, MRR, NDCG, Recall

    name = metric.lower()
    if name == "recall":
        m = Recall(k=k)
    elif name == "ndcg":
        m = NDCG(k=k)
    elif name == "auc":
        m = AUC()
    elif name == "mrr":
        m = MRR()
    else:
        raise ValueError(
            f"unknown validation metric {metric!r}; choose recall, ndcg, auc, or mrr"
        )
    avg_results, _ = ranking_eval(model, [m], train_set, val_set, mode="last")
    return avg_results[0]


def fit_sessions(model, opt, inputs, targets, mask, bsz, loss_fn, train_set, val_set):
    """The session models' training loop (GRU4Rec, SASRec), on
    ``model.params`` (a module on the model's device) in place.

    ``inputs``, ``targets``, ``mask``: (n, L) numpy rows, n a multiple of
    ``bsz``; ``loss_fn(seq, tgt, m, generator)`` the loss of one batch,
    its draws (dropout, negatives) from ``generator``. Each epoch draws a
    permutation of the rows and then every batch's draws from one
    generator keyed on (seed, global epoch), so neither the host's chunking
    nor a resume from a checkpoint changes the stream. ``epoch_loop`` runs
    the epochs; with ``model_selection='best'`` and a validation set, every
    ``val_eval_every`` epochs the validation metric is taken and the best
    parameters so far ride in the checkpointed state, and the fit ends on
    them. The reported loss is the last epoch's sum."""
    from ..ops.optim import step
    from ..utils.checkpoint import epoch_generator, epoch_loop

    dev = model._device()
    params = dict(model.params.named_parameters())
    inputs_d = torch.as_tensor(inputs, dtype=torch.int64, device=dev)
    targets_d = torch.as_tensor(targets, dtype=torch.int64, device=dev)
    mask_d = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    n_rows = inputs_d.shape[0]
    n_batches = n_rows // bsz
    seed = model.rng.randint(2**31)
    select_best = model.model_selection == "best" and val_set is not None

    def run_chunk(state, start, e):
        opt_state = state["opt"]
        for epoch in range(start, start + e):
            gen = epoch_generator(seed, epoch, dev)
            order = torch.randperm(n_rows, generator=gen, device=dev)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for b in range(n_batches):
                idx = order[b * bsz:(b + 1) * bsz]
                loss = loss_fn(inputs_d[idx], targets_d[idx], mask_d[idx], gen)
                opt_state = step(params, opt, opt_state, loss)
                loss_sum += loss.detach()
        state = dict(state, opt=opt_state)
        info = {"loss": loss_sum}
        if select_best:
            score = val_score(model, train_set, val_set, model.val_metric, model.val_k)
            info["val"] = score
            if score > state["best_score"]:
                with torch.no_grad():
                    for name, p in params.items():
                        state["best"][name].copy_(p)
                state["best_score"] = float(score)
        return state, info

    def report(done, info):
        print("Epoch %d/%d, loss: %.4f"
              % (done, model.n_epochs, float(info["loss"]) / n_batches))
        if "val" in info:
            print("  val %s@%d = %.4f" % (model.val_metric, model.val_k, info["val"]))

    state = {"opt": opt.init(params),
             "best": {name: p.detach().clone() for name, p in params.items()},
             "best_score": -np.inf}
    state = epoch_loop(model, model.n_epochs, run_chunk, state, on_report=report,
                       max_chunk=model.val_eval_every if select_best else None,
                       resident=params)
    if select_best and np.isfinite(state["best_score"]):
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["best"][name])
