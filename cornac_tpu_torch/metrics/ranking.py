"""Ranking metrics.

Port of ``cornac_tpu/metrics/ranking.py``. Two computation paths per
metric, as in the JAX package:

- ``compute(...)``: per-user, numpy — the reference's inputs/outputs
  (``gt_pos``/``gt_neg`` index vectors, ``pd_rank`` ranked candidate
  indices, ``pd_scores`` candidate scores).
- ``batch_compute(ctx)``: vectorized over a batch of users via a shared
  :class:`RankingContext` of rank/count arrays derived from a dense score
  matrix.

The JAX package's fused device program (``_fused_metrics_kernel``) is XLA
built from ``jax.numpy``; here it is plain PyTorch on the scores' device
(``batch_eval_device``), computing the same float32 quantities, sharded
over a (data, model) mesh when given one.
"""

import numpy as np
import torch
from scipy.stats import rankdata

from ..device import default_device

# Minimum B*N score-matrix size before RankingContext computes ranks and
# tie counts on the default device instead of with numpy.
_DEVICE_MIN_CELLS = 8_000_000


def set_device_metrics_min_cells(n):
    """Set the score-matrix size (B * N cells) from which ``RankingContext``
    ranks on the device (``config.RuntimeConfig.device_metrics_min_cells``)."""
    global _DEVICE_MIN_CELLS
    _DEVICE_MIN_CELLS = int(n)


def _device_rank_and_ties(scores, pos_mask, cand_mask, ties=True):
    """(rank_of, c_lt, p_lt) as int32 numpy arrays, computed on the default
    device (or a score tensor's own) by stable sorts and permutation
    inverses, scores compared in float32 as in the JAX package;
    ``(rank_of,)`` alone without ``ties`` (the same stable sort, so the
    same ranks)."""
    if isinstance(scores, torch.Tensor):  # where the model made them
        scores = scores.to(torch.float32)
    else:
        scores = torch.as_tensor(np.asarray(scores, np.float32), device=default_device())
    dev = scores.device
    B, N = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    iota = torch.arange(N, device=dev).expand(B, N)
    rank_of = torch.empty((B, N), dtype=torch.int64, device=dev).scatter_(1, order, iota)
    if not ties:
        return (rank_of.to(torch.int32).cpu().numpy(),)
    pos_mask = torch.as_tensor(np.asarray(pos_mask, bool), device=dev)
    cand_mask = torch.as_tensor(np.asarray(cand_mask, bool), device=dev)

    s = torch.where(cand_mask, scores, -torch.inf)
    rev = order.flip(1)  # ascending
    s_sorted = s.gather(1, rev)
    cand_sorted = cand_mask.gather(1, rev)
    pos_sorted = pos_mask.gather(1, rev)

    new_group = torch.ones((B, N), dtype=torch.bool, device=dev)
    new_group[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
    group_start = torch.cummax(torch.where(new_group, iota, 0), dim=1).values

    zeros = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    cand_cum = torch.cat([zeros, torch.cumsum(cand_sorted, dim=1)], dim=1)
    pos_cum = torch.cat([zeros, torch.cumsum(pos_sorted, dim=1)], dim=1)
    c_lt_sorted = cand_cum.gather(1, group_start)
    p_lt_sorted = pos_cum.gather(1, group_start)

    inv_rev = (N - 1) - rank_of
    c_lt = c_lt_sorted.gather(1, inv_rev)
    p_lt = p_lt_sorted.gather(1, inv_rev)
    return tuple(t.to(torch.int32).cpu().numpy() for t in (rank_of, c_lt, p_lt))


def _device_target_ranks(scores, targets):
    """(B, 1) int64 numpy: the 0-based rank of each row's one positive
    column ``targets[b]`` in a score tensor, counted where the tensor lies:
    the columns scored above it plus those tied with it at a lower index,
    its place in the stable descending sort of ``_device_rank_and_ties``
    (float32 compares); only the ranks leave the device."""
    s = scores.to(torch.float32)
    t = torch.as_tensor(targets, dtype=torch.int64, device=s.device)[:, None]
    st = s.gather(1, t)
    cols = torch.arange(s.shape[1], device=s.device)[None, :]
    ranks = (s > st).sum(1) + ((s == st) & (cols < t)).sum(1)
    return ranks.cpu().numpy()[:, None]


# --------------------------------------------------------------------- #
# fully-fused device evaluation
# --------------------------------------------------------------------- #
# Per-positive counts stay < N and AUC uses the mean-of-fractions form, so
# float32 counts are exact up to N = 2^24 items: that bound is the gate.
_FUSED_MAX_ITEMS = 1 << 24

# per-eval-batch score-cell cap (B*N): the eval loop shrinks its user batch
# so the dense masks and the score block stay bounded for any catalog
_EVAL_CELL_BUDGET = 64 * 1024 * 1024

_RANK_SENTINEL = 2**31 - 1


def _unpack_bits(bits, N):
    """(B, ceil(N/8)) uint8 (np.packbits big-endian) -> (B, N) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    bools = (bits[:, :, None] >> shifts) & 1
    return bools.reshape(bits.shape[0], -1)[:, :N] != 0


def _rank_counts(s, cand_mask, sp, safe_idx, col0=0):
    """Per-positive counts over a block of columns: (above, tie_lo, c_lt)
    (B, P) int64, the candidates scored above each positive, those tied
    with it at a smaller column, those scored below, and n_cand (B,).
    ``s``: (B, n) scores of columns ``col0 .. col0 + n - 1``, ``-inf`` off
    the candidates; ``sp``: (B, P) the positives' scores; ``safe_idx``: their
    global columns. Integers, so blocks add up to the whole row's counts.
    The passes run one slot at a time, which bounds the memory at (B, n)."""
    B, n = s.shape
    P = sp.shape[1]
    iota = torch.arange(col0, col0 + n, device=s.device)[None, :]
    above = torch.empty((B, P), dtype=torch.int64, device=s.device)
    tie_lo = torch.empty_like(above)
    c_lt = torch.empty_like(above)
    for p in range(P):
        sp_p = sp[:, p : p + 1]
        above[:, p] = ((s > sp_p) & cand_mask).sum(1)
        tie_lo[:, p] = (
            (s == sp_p) & cand_mask & (iota < safe_idx[:, p : p + 1])
        ).sum(1)
        c_lt[:, p] = ((s < sp_p) & cand_mask).sum(1)
    return above, tie_lo, c_lt, cand_mask.sum(1)


def _fused_metrics(scores, cand_bits, pos_idx, specs, dtype=torch.float32, block=None):
    """(B, M) float32 metric values for a static tuple of (kind, k) specs:
    the JAX package's ``_fused_metrics_kernel``.

    Sort-free: every supported metric needs only per-positive quantities,
    the rank of each positive (candidates scored above it, ties broken by
    column index like the host stable argsort) and its strict-below tie
    counts, so each positive slot costs one compare-and-count pass over
    its row (``_rank_counts``).

    ``block``: ``(col0, col1, reduce)`` counts only columns ``col0:col1``
    and passes the (B, 3P + 1) int64 counts to ``reduce``, which returns
    the whole rows' counts (the mesh branch of ``batch_eval_device`` sums
    them over the model axis)."""
    B, N = scores.shape
    dev = scores.device
    cand_mask = _unpack_bits(cand_bits, N)
    s = torch.where(cand_mask, scores.to(dtype), -torch.inf)

    valid = pos_idx >= 0  # (B, P); padded slots are -1
    safe_idx = pos_idx.clamp(min=0).long()
    sp = s.gather(1, safe_idx)  # (B, P)
    if block is None:
        above, tie_lo, c_lt, n_cand = _rank_counts(s, cand_mask, sp, safe_idx)
    else:
        col0, col1, reduce = block
        counts = _rank_counts(s[:, col0:col1], cand_mask[:, col0:col1], sp, safe_idx, col0)
        counts = reduce(torch.cat([c.reshape(B, -1) for c in counts], 1))
        above, tie_lo, c_lt, n_cand = counts.split([sp.shape[1]] * 3 + [1], 1)
        n_cand = n_cand[:, 0]
    pos_ranks = torch.where(valid, above + tie_lo, _RANK_SENTINEL)
    p_lt = ((sp[:, None, :] < sp[:, :, None]) & valid[:, None, :]).sum(2)

    n_pos = valid.sum(1)
    n_neg = n_cand - n_pos

    # shared ideal-prefix tables (indexed by a per-row count)
    max_ideal = min(sp.shape[1], N)
    ar = torch.arange(max_ideal, dtype=torch.float32, device=dev)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    disc_cum = torch.cat([zero, torch.cumsum(1.0 / torch.log2(ar + 2.0), 0)])
    harm_cum = torch.cat([zero, torch.cumsum(1.0 / (ar + 1.0), 0)])

    pr_f = pos_ranks.to(torch.float32)
    n_pos_f = n_pos.clamp(min=1).to(torch.float32)

    outs = []
    for kind, k in specs:
        ke = torch.full((B,), k, device=dev) if k > 0 else n_cand
        in_k = pos_ranks < ke[:, None]
        n_ideal = torch.minimum(n_pos, ke.clamp(max=max_ideal))
        if kind == "ndcg":
            dcg = torch.where(in_k, 1.0 / torch.log2(pr_f + 2.0), 0.0).sum(1)
            outs.append(dcg / disc_cum[n_ideal].clamp(min=1e-12))
        elif kind == "ncrr":
            crr = torch.where(in_k, 1.0 / (pr_f + 1.0), 0.0).sum(1)
            icrr = harm_cum[n_ideal].clamp(min=1e-12)
            outs.append(torch.where(crr > 0, crr / icrr, 0.0))
        elif kind == "mrr":
            first = pos_ranks.min(1).values.to(torch.float32)
            outs.append(1.0 / (first + 1.0))
        elif kind in ("hit", "prec", "rec", "f1"):
            tp = in_k.sum(1).to(torch.float32)
            prec = tp / ke.to(torch.float32)
            rec = tp / n_pos_f
            if kind == "hit":
                outs.append((tp > 0).to(torch.float32))
            elif kind == "prec":
                outs.append(prec)
            elif kind == "rec":
                outs.append(rec)
            else:
                denom = prec + rec
                outs.append(
                    torch.where(denom > 0, 2.0 * prec * rec / denom.clamp(min=1e-12), 0.0)
                )
        elif kind == "auc":
            # mean-of-fractions form: each per-positive negatives-below count
            # is < N, so no N^2-scale integer sum exists
            frac = torch.where(valid, (c_lt - p_lt).to(torch.float32), 0.0)
            frac = frac / n_neg.clamp(min=1).to(torch.float32)[:, None]
            outs.append(frac.sum(1) / n_pos_f)
        elif kind == "map":
            c_ge = (n_cand[:, None] - c_lt).to(torch.float32)
            p_ge = (n_pos[:, None] - p_lt).to(torch.float32)
            ap = torch.where(valid, p_ge / c_ge.clamp(min=1.0), 0.0).sum(1)
            outs.append(ap / n_pos_f)
        else:  # pragma: no cover - specs are validated by the caller
            raise ValueError(kind)
    return torch.stack(outs, dim=1)


def metric_device_specs(metrics):
    """Static (kind, k) spec per metric, or None when any metric has no
    fused device implementation (exact type match only — subclasses may
    override ``compute`` semantics)."""
    table = {
        NDCG: "ndcg",
        NCRR: "ncrr",
        MRR: "mrr",
        HitRatio: "hit",
        Precision: "prec",
        Recall: "rec",
        FMeasure: "f1",
        AUC: "auc",
        MAP: "map",
    }
    specs = []
    for m in metrics:
        kind = table.get(type(m))
        if kind is None:
            return None
        k = getattr(m, "k", -1)
        if hasattr(k, "__len__"):
            return None
        specs.append((kind, int(k)))
    return tuple(specs)


def batch_eval_device(scores_dev, pos_mask, cand_mask, specs, dtype=torch.float32, mesh=None):
    """Run the fused metric program: ``scores_dev`` is a (B, N) tensor
    (numpy goes to the default device), masks are host bool arrays;
    ``dtype`` is what the scores are compared in (float32, as the JAX
    package's fused program; float64 where the JAX package ranks on the
    host in float64, as its next-basket eval does).
    Returns a (B, M) float64 numpy array, the only device->host copy.

    With ``mesh`` (``parallel.make_mesh``; every rank calls it with the
    same scores and masks), the program runs sharded, users over the data
    axis and items over the model axis, as the JAX package lays it out:
    users are padded to the data size and items to 8 x the model size
    (padded items are never candidates). Each rank counts the ranks and
    ties of its (user block, item block), the counts are summed over
    "model" and the metric rows gathered over "data". The counts are
    integers, so every rank gets the unsharded result."""
    if not isinstance(scores_dev, torch.Tensor):
        if mesh is None:
            dev = default_device()
        else:
            from ..parallel.mesh import mesh_device

            dev = mesh_device(mesh)
        scores_dev = torch.as_tensor(np.asarray(scores_dev), device=dev)
    dev = scores_dev.device

    pos_mask = np.asarray(pos_mask, dtype=bool)
    B = pos_mask.shape[0]
    counts = pos_mask.sum(axis=1)
    # (B, P) positive column ids, -1 padded; P rounded to a power of two as
    # in the JAX package
    max_c = max(int(counts.max(initial=1)), 1)
    P = 1 << (max_c - 1).bit_length()
    rows, cols = np.nonzero(pos_mask)  # row-major: per-row runs contiguous
    starts = np.cumsum(counts) - counts
    offs = np.arange(len(rows)) - starts[rows]
    pos_idx = np.full((B, P), -1, dtype=np.int32)
    pos_idx[rows, offs] = cols

    cand = np.asarray(cand_mask, dtype=bool)
    if mesh is None:
        out = _fused_metrics(
            scores_dev,
            torch.as_tensor(np.packbits(cand, axis=1), device=dev),
            torch.as_tensor(pos_idx, device=dev),
            specs,
            dtype,
        )
        return out.cpu().numpy().astype(np.float64)

    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
    from ..parallel.sharded import all_sum, gather_batch

    dsz, msz = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    N = cand.shape[1]
    b_pad, n_pad = (-B) % dsz, (-N) % (8 * msz)
    cand = np.pad(cand, ((0, b_pad), (0, n_pad)))
    pos_idx = np.pad(pos_idx, ((0, b_pad), (0, 0)), constant_values=-1)
    scores = torch.nn.functional.pad(scores_dev.to(torch.float32), (0, n_pad, 0, b_pad))
    per_b, per_n = (B + b_pad) // dsz, (N + n_pad) // msz
    lo = mesh.get_local_rank(DATA_AXIS) * per_b
    col0 = mesh.get_local_rank(MODEL_AXIS) * per_n
    out = _fused_metrics(
        scores[lo:lo + per_b],
        torch.as_tensor(np.packbits(cand[lo:lo + per_b], axis=1), device=dev),
        torch.as_tensor(pos_idx[lo:lo + per_b], device=dev),
        specs,
        dtype,
        block=(col0, col0 + per_n, lambda c: all_sum(mesh, c, MODEL_AXIS)),
    )
    out = gather_batch(mesh, out, B + b_pad, per_b)
    return out[:B].cpu().numpy().astype(np.float64)


class RankingContext:
    """Lazily-computed per-batch ranking quantities.

    Parameters
    ----------
    scores: (B, N) float array or tensor
        Model scores; columns outside the candidate set must be ``-inf``.
        A tensor is ranked on its own device, whatever its size.
    pos_mask: (B, N) bool array
        Ground-truth positive items (a subset of the candidate set).
    cand_mask: (B, N) bool array
        Candidate items under evaluation (positives + negatives).
    ties: bool
        Whether a metric will read the tie counts (``c_lt``/``p_lt``: AUC,
        MAP; ``RankingMetric.uses_ties``). The device path computes them
        with the ranks or not at all.
    targets: (B,) int array, optional
        In place of the masks: one positive a row, at that column, and
        every column a candidate (the next-item evaluation's rows). On a
        score tensor without tie counts, the device path then counts the
        targets' ranks alone.
    """

    def __init__(self, scores, pos_mask=None, cand_mask=None, ties=True, targets=None):
        self.scores = scores
        self.ties = ties
        self.B, self.N = scores.shape
        self.targets = None if targets is None else np.asarray(targets, dtype=np.int64)
        self._pos_mask, self._cand_mask = pos_mask, cand_mask
        if self.targets is None:
            self.n_pos = pos_mask.sum(axis=1)
            self.n_cand = cand_mask.sum(axis=1)
        else:
            self.n_pos = np.ones(self.B, dtype=np.int64)
            self.n_cand = np.full(self.B, self.N, dtype=np.int64)
        self.n_neg = self.n_cand - self.n_pos
        self._rank_of = None
        self._pos_ranks = None
        self._tie_counts = None

    @property
    def pos_mask(self):
        if self._pos_mask is None:  # built from the targets when first read
            self._pos_mask = np.zeros((self.B, self.N), dtype=bool)
            self._pos_mask[np.arange(self.B), self.targets] = True
        return self._pos_mask

    @property
    def cand_mask(self):
        if self._cand_mask is None:
            self._cand_mask = np.ones((self.B, self.N), dtype=bool)
        return self._cand_mask

    def _try_device_path(self):
        """At large batch sizes, compute order/ranks/tie-counts on the
        default device, and always on a score tensor's own (a failure there
        raises; nothing falls back)."""
        on_device = isinstance(self.scores, torch.Tensor)
        if not on_device and self.B * self.N < _DEVICE_MIN_CELLS:
            return False
        if on_device and self.targets is not None and not self.ties:
            self._pos_ranks = _device_target_ranks(self.scores, self.targets)
        else:
            rank_and_ties = _device_rank_and_ties(
                self.scores, self.pos_mask, self.cand_mask, ties=self.ties
            )
            self._rank_of = rank_and_ties[0]
            if self.ties:
                self._tie_counts = rank_and_ties[1:]
        # rank_of/tie caches make the column order itself unnecessary;
        # mark it filled so the host argsort never runs
        self._order = "device"
        return True

    @property
    def _desc_order(self):
        """(B, N) stable descending-score column order (single shared sort:
        tie counts reuse its reverse, since c_lt/p_lt only depend on tie-
        group boundaries, which are intra-group-order invariant)."""
        if getattr(self, "_order", None) is None:
            if not self._try_device_path():
                self._order = np.argsort(-self.scores, axis=1, kind="stable")
        return self._order

    @property
    def rank_of(self):
        """(B, N) int: 0-based descending-score rank of each column
        (excluded columns sink to the bottom; ties broken by column index)."""
        if self._rank_of is None:
            order = self._desc_order  # may fill the cache via the device path
        if self._rank_of is None:
            self._rank_of = np.empty_like(order)
            rows = np.arange(self.B)[:, None]
            self._rank_of[rows, order] = np.arange(self.N)[None, :]
        return self._rank_of

    # sentinel rank for non-positive columns: must compare greater than any
    # truncation cutoff, including k > N (a sentinel of N breaks there: the
    # non-positive columns would pass ``rank < k`` and inflate every @k
    # metric on catalogs smaller than k)
    OUT_OF_RANGE = np.int64(2**31)

    @property
    def pos_ranks(self):
        """(B, N) int: rank of each positive column, OUT_OF_RANGE elsewhere
        (computed once per context; every metric reads it); (B, 1), the
        targets' ranks, where the device path counted those alone."""
        if self._pos_ranks is None:
            self._desc_order  # the device path may fill it: (B, 1) for targets
        if self._pos_ranks is None:
            self._pos_ranks = np.where(self.pos_mask, self.rank_of, self.OUT_OF_RANGE)
        return self._pos_ranks

    def _compute_tie_counts(self):
        """For every column j (restricted to candidates): the number of
        candidates with score strictly below scores[:, j] (``c_lt``) and the
        number of positives with score strictly below (``p_lt``). Exact under
        ties — one ascending sort + prefix sums per row."""
        order_probe = self._desc_order  # may fill the cache via device path
        if self._tie_counts is not None:
            return
        if isinstance(order_probe, str):  # ranked on the device
            raise RuntimeError("RankingContext(ties=False): no metric was to read the tie "
                               "counts")
        s = np.where(self.cand_mask, self.scores, -np.inf)
        # ascending order; excluded (-inf) first. Reuses the shared
        # descending sort — valid because scores obey the -inf contract and
        # every derived quantity is invariant to order within tie groups.
        order = self._desc_order[:, ::-1]
        rows = np.arange(self.B)[:, None]
        s_sorted = np.take_along_axis(s, order, axis=1)
        cand_sorted = np.take_along_axis(self.cand_mask, order, axis=1)
        pos_sorted = np.take_along_axis(self.pos_mask, order, axis=1)

        # index (within sorted row) of the first element of each tie group
        idx = np.arange(self.N)[None, :]
        new_group = np.ones((self.B, self.N), dtype=bool)
        new_group[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
        group_start = np.maximum.accumulate(np.where(new_group, idx, 0), axis=1)

        # prefix counts of candidates / positives before a sorted position
        cand_cum = np.concatenate(
            [np.zeros((self.B, 1), dtype=np.int64), np.cumsum(cand_sorted, axis=1)],
            axis=1,
        )
        pos_cum = np.concatenate(
            [np.zeros((self.B, 1), dtype=np.int64), np.cumsum(pos_sorted, axis=1)],
            axis=1,
        )
        c_lt_sorted = np.take_along_axis(cand_cum, group_start, axis=1)
        p_lt_sorted = np.take_along_axis(pos_cum, group_start, axis=1)

        c_lt = np.empty((self.B, self.N), dtype=np.int64)
        p_lt = np.empty((self.B, self.N), dtype=np.int64)
        c_lt[rows, order] = c_lt_sorted
        p_lt[rows, order] = p_lt_sorted
        self._tie_counts = (c_lt, p_lt)

    @property
    def c_lt(self):
        """(B, N): per column, #candidates with strictly lower score."""
        if self._tie_counts is None:
            self._compute_tie_counts()
        return self._tie_counts[0]

    @property
    def p_lt(self):
        """(B, N): per column, #positives with strictly lower score."""
        if self._tie_counts is None:
            self._compute_tie_counts()
        return self._tie_counts[1]

    def truncation(self, k):
        """(B,) effective cutoff length: ``k`` if positive else the full
        candidate-list length (reference truncates ``pd_rank[:k]``)."""
        if k > 0:
            return np.full(self.B, k, dtype=np.int64)
        return self.n_cand

    def tp_at_k(self, k):
        """(B,) number of positives ranked inside the cutoff."""
        k_eff = self.truncation(k)[:, None]
        return (self.pos_ranks < k_eff).sum(axis=1)


class RankingMetric:
    """Base ranking metric (higher is better). ``uses_ties``: whether
    ``batch_compute`` reads the context's tie counts."""

    uses_ties = False

    def __init__(self, name=None, k=-1, higher_better=True):
        assert hasattr(k, "__len__") or k == -1 or k > 0
        self.type = "ranking"
        self.name = name
        self.k = k
        self.higher_better = higher_better

    def compute(self, **kwargs):
        raise NotImplementedError()

    def batch_compute(self, ctx):
        """Vectorized metric over a :class:`RankingContext`; returns (B,)."""
        raise NotImplementedError()


class NDCG(RankingMetric):
    """Normalized Discounted Cumulative Gain (binary relevance)."""

    def __init__(self, k=-1):
        RankingMetric.__init__(self, name="NDCG@{}".format(k), k=k)

    @staticmethod
    def dcg_score(gt_pos, pd_rank, k=-1):
        """DCG over the (optionally truncated) ranked list with 0/1 gains."""
        truncated = pd_rank[:k] if k > 0 else pd_rank
        rel = np.isin(truncated, gt_pos).astype(int)
        gain = 2**rel - 1
        discounts = np.log2(np.arange(len(rel)) + 2)
        return np.sum(gain / discounts)

    def compute(self, gt_pos, pd_rank, **kwargs):
        dcg = self.dcg_score(gt_pos, pd_rank, self.k)
        idcg = self.dcg_score(gt_pos, gt_pos, self.k)
        return dcg / idcg

    def batch_compute(self, ctx):
        k_eff = ctx.truncation(self.k)[:, None]
        pos_ranks = ctx.pos_ranks
        dcg = np.where(
            pos_ranks < k_eff, 1.0 / np.log2(pos_ranks + 2.0), 0.0
        ).sum(axis=1)
        # ideal: positives occupy the first min(n_pos, k_eff) slots
        n_ideal = np.minimum(ctx.n_pos, k_eff[:, 0])
        max_n = int(n_ideal.max()) if len(n_ideal) else 0
        discounts = 1.0 / np.log2(np.arange(max_n) + 2.0)
        cum = np.concatenate([[0.0], np.cumsum(discounts)])
        idcg = cum[n_ideal]
        return dcg / np.maximum(idcg, 1e-12)


class NCRR(RankingMetric):
    """Normalized Cumulative Reciprocal Rank."""

    def __init__(self, k=-1):
        RankingMetric.__init__(self, name="NCRR@{}".format(k), k=k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        truncated = pd_rank[: self.k] if self.k > 0 else pd_rank
        hit_positions = np.where(np.isin(truncated, gt_pos))[0]
        if len(hit_positions) == 0:
            return 0.0
        crr = np.sum(1.0 / (hit_positions + 1))
        max_nb_pos = min(len(gt_pos), len(truncated))
        icrr = np.sum(1.0 / (np.arange(max_nb_pos) + 1))
        return crr / icrr

    def batch_compute(self, ctx):
        k_eff = ctx.truncation(self.k)[:, None]
        pos_ranks = ctx.pos_ranks
        crr = np.where(pos_ranks < k_eff, 1.0 / (pos_ranks + 1.0), 0.0).sum(axis=1)
        n_ideal = np.minimum(ctx.n_pos, k_eff[:, 0])
        max_n = int(n_ideal.max()) if len(n_ideal) else 0
        cum = np.concatenate([[0.0], np.cumsum(1.0 / (np.arange(max_n) + 1.0))])
        icrr = cum[n_ideal]
        return np.where(crr > 0, crr / np.maximum(icrr, 1e-12), 0.0)


class MRR(RankingMetric):
    """Mean Reciprocal Rank (reciprocal rank of the first hit)."""

    def __init__(self):
        RankingMetric.__init__(self, name="MRR")

    def compute(self, gt_pos, pd_rank, **kwargs):
        matched = np.nonzero(np.isin(pd_rank, gt_pos))[0]
        if len(matched) == 0:
            raise ValueError(
                "No matched between ground-truth items and recommendations"
            )
        return 1.0 / (matched[0] + 1)

    def batch_compute(self, ctx):
        first_pos_rank = ctx.pos_ranks.min(axis=1)
        return 1.0 / (first_pos_rank + 1.0)


class MeasureAtK(RankingMetric):
    """Shared tp / tp+fn / tp+fp computation for @K measures."""

    def __init__(self, name=None, k=-1):
        RankingMetric.__init__(self, name, k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        truncated = pd_rank[: self.k] if self.k > 0 else pd_rank
        tp = np.sum(np.isin(truncated, gt_pos))
        tp_fn = len(gt_pos)
        tp_fp = self.k if self.k > 0 else len(truncated)
        return tp, tp_fn, tp_fp

    def _batch_counts(self, ctx):
        tp = ctx.tp_at_k(self.k)
        tp_fn = ctx.n_pos
        tp_fp = ctx.truncation(self.k)
        return tp, tp_fn, tp_fp


class HitRatio(MeasureAtK):
    """1.0 when at least one positive appears in the top-k."""

    def __init__(self, k=-1):
        super().__init__(name="HitRatio@{}".format(k), k=k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        tp, *_ = MeasureAtK.compute(self, gt_pos, pd_rank, **kwargs)
        return 1.0 if tp > 0 else 0.0

    def batch_compute(self, ctx):
        tp, _, _ = self._batch_counts(ctx)
        return (tp > 0).astype(np.float64)


class Precision(MeasureAtK):
    """Precision@K."""

    def __init__(self, k=-1):
        super().__init__(name="Precision@{}".format(k), k=k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        tp, _, tp_fp = MeasureAtK.compute(self, gt_pos, pd_rank, **kwargs)
        return tp / tp_fp

    def batch_compute(self, ctx):
        tp, _, tp_fp = self._batch_counts(ctx)
        return tp / tp_fp


class Recall(MeasureAtK):
    """Recall@K."""

    def __init__(self, k=-1):
        super().__init__(name="Recall@{}".format(k), k=k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        tp, tp_fn, _ = MeasureAtK.compute(self, gt_pos, pd_rank, **kwargs)
        return tp / tp_fn

    def batch_compute(self, ctx):
        tp, tp_fn, _ = self._batch_counts(ctx)
        return tp / np.maximum(tp_fn, 1)


class FMeasure(MeasureAtK):
    """F1@K."""

    def __init__(self, k=-1):
        super().__init__(name="F1@{}".format(k), k=k)

    def compute(self, gt_pos, pd_rank, **kwargs):
        tp, tp_fn, tp_fp = MeasureAtK.compute(self, gt_pos, pd_rank, **kwargs)
        prec = tp / tp_fp
        rec = tp / tp_fn
        return 2 * (prec * rec) / (prec + rec) if (prec + rec) > 0 else 0

    def batch_compute(self, ctx):
        tp, tp_fn, tp_fp = self._batch_counts(ctx)
        prec = tp / tp_fp
        rec = tp / np.maximum(tp_fn, 1)
        denom = prec + rec
        return np.where(denom > 0, 2 * prec * rec / np.maximum(denom, 1e-12), 0.0)


class AUC(RankingMetric):
    """Area under the ROC curve over (positive, negative) candidate pairs."""

    uses_ties = True

    def __init__(self):
        RankingMetric.__init__(self, name="AUC")

    def compute(self, item_indices, pd_scores, gt_pos, gt_neg=None, **kwargs):
        pos_mask = np.isin(item_indices, gt_pos)
        neg_mask = (
            np.logical_not(pos_mask) if gt_neg is None else np.isin(item_indices, gt_neg)
        )
        pos_scores = pd_scores[pos_mask]
        neg_scores = pd_scores[neg_mask]
        ui_scores = np.repeat(pos_scores, len(neg_scores))
        uj_scores = np.tile(neg_scores, len(pos_scores))
        return (ui_scores > uj_scores).sum() / len(uj_scores)

    def batch_compute(self, ctx):
        # pairs won: for each positive, #negatives with strictly lower score
        neg_lt = np.where(ctx.pos_mask, ctx.c_lt - ctx.p_lt, 0).sum(axis=1)
        denom = ctx.n_pos * ctx.n_neg
        return neg_lt / np.maximum(denom, 1)


class MAP(RankingMetric):
    """Mean Average Precision (rankdata 'max' convention of the reference)."""

    uses_ties = True

    def __init__(self):
        RankingMetric.__init__(self, name="MAP")

    def compute(self, item_indices, pd_scores, gt_pos, **kwargs):
        relevant = np.isin(item_indices, gt_pos)
        rank = rankdata(-pd_scores, "max")[relevant]
        L = rankdata(-pd_scores[relevant], "max")
        return (L / rank).mean()

    def batch_compute(self, ctx):
        # rankdata('max') of -scores == #candidates with score >= s
        c_ge = ctx.n_cand[:, None] - ctx.c_lt
        p_ge = ctx.n_pos[:, None] - ctx.p_lt
        ap = np.where(ctx.pos_mask, p_ge / np.maximum(c_ge, 1), 0.0).sum(axis=1)
        return ap / np.maximum(ctx.n_pos, 1)
